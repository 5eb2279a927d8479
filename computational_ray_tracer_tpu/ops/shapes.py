"""Analytic shape intersection: rays, bounds, transforms, quadrics.

Capability parity with ``RayTracer/Shapes.h:33-758`` (Ray, Bounds3 with the
robust ``1+2*gamma(3)`` slab test, Shape transforms, clipped Sphere /
Cylinder / Disk with PBRT-stable quadratic solves, hit refinement, and
analytic dpdu/dpdv/normals), array-first:

- rays are SoA arrays ``o (..., 3), d (..., 3), t_max (...)``;
- shapes live in *type-tagged tensor tables* (one array per parameter, leading
  axis = shape count) instead of virtual dispatch;
- intersection is two-phase: a cheap vectorized ``*_intersect_t`` over all
  (ray, shape) pairs producing hit distances, then ``*_surface`` evaluated
  only for each ray's winning shape (gather + elementwise);
- everything is differentiable w.r.t. shape parameters.

Shapes are defined in their canonical object space (z-up, like the
reference's "object space z-up" convention, Shapes.h:177-181) and placed by
4x4 object→world transforms.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp

# float32 machine epsilon / 2 — the reference's rounding-error machinery
# (pbrt gamma(n), helpers.h:52)
MACHINE_EPS = float(np.finfo(np.float32).eps) / 2.0


def fp_gamma(n):
    """gamma(n) = n*eps / (1 - n*eps): conservative FP error bound."""
    ne = n * MACHINE_EPS
    return ne / (1.0 - ne)


def difference_of_products(a, b, c, d):
    """a*b - c*d with exact-product corrections (DifferenceOfProducts,
    helpers.h:56-62). jnp exposes no FMA, so both products get a
    Dekker-split error term; symmetric inputs (a*b == c*d exactly) yield an
    exact 0 — the property the watertight triangle test relies on."""
    ab = a * b
    cd = c * d
    e_ab = _two_prod_err(a, b, ab)
    e_cd = _two_prod_err(c, d, cd)
    return (ab - cd) + (e_ab - e_cd)


def _two_prod_err(a, b, ab):
    """Error of the rounded product ab = fl(a*b) via Dekker splitting."""
    split = jnp.float32(4097.0)  # 2^12 + 1 for float32 (24-bit mantissa)
    a_hi = (a * split) - (a * split - a)
    a_lo = a - a_hi
    b_hi = (b * split) - (b * split - b)
    b_lo = b - b_hi
    return ((a_hi * b_hi - ab) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo


# ---------------------------------------------------------------------------
# Transforms (TransformRay/TransformBounds, Shapes.h:60-142)
# ---------------------------------------------------------------------------

def make_transform(translate=(0, 0, 0), rotate_deg=(0, 0, 0), scale=1.0):
    """Host-side 4x4 object->world matrix (+inverse) from TRS. Rotations are
    applied X then Y then Z (degrees)."""
    t = np.asarray(translate, np.float64)
    s = np.asarray(scale, np.float64) * np.ones(3)
    rx, ry, rz = [math.radians(a) for a in rotate_deg]

    def rot_x(a):
        return np.array([[1, 0, 0], [0, math.cos(a), -math.sin(a)],
                         [0, math.sin(a), math.cos(a)]])

    def rot_y(a):
        return np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                         [-math.sin(a), 0, math.cos(a)]])

    def rot_z(a):
        return np.array([[math.cos(a), -math.sin(a), 0],
                         [math.sin(a), math.cos(a), 0], [0, 0, 1]])

    r = rot_z(rz) @ rot_y(ry) @ rot_x(rx)
    m = np.eye(4)
    m[:3, :3] = r * s[None, :]
    m[:3, 3] = t
    return m.astype(np.float32), np.linalg.inv(m).astype(np.float32)


def transform_point(m, p):
    """(..., 4, 4) x (..., 3) -> (..., 3)."""
    ph = jnp.concatenate([p, jnp.ones_like(p[..., :1])], axis=-1)
    out = jnp.einsum("...ij,...j->...i", m, ph, precision="highest")
    return out[..., :3]


def transform_vector(m, v):
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], v,
                      precision="highest")


def transform_normal(m_inv, n):
    """Normals transform by the inverse transpose (Shapes.h:160-166)."""
    return jnp.einsum("...ji,...j->...i", m_inv[..., :3, :3], n,
                      precision="highest")


def transform_ray(m, o, d):
    return transform_point(m, o), transform_vector(m, d)


# ---------------------------------------------------------------------------
# Bounds3 (Shapes.h:52-127)
# ---------------------------------------------------------------------------

def bounds_union(lo_a, hi_a, lo_b, hi_b):
    return jnp.minimum(lo_a, lo_b), jnp.maximum(hi_a, hi_b)


def transform_bounds(m, lo, hi):
    """Transform an AABB by its 8 corners (Bounds3::Transform,
    Shapes.h:60-98)."""
    corners = []
    for ix in (0, 1):
        for iy in (0, 1):
            for iz in (0, 1):
                c = jnp.stack([jnp.where(ix, hi[..., 0], lo[..., 0]),
                               jnp.where(iy, hi[..., 1], lo[..., 1]),
                               jnp.where(iz, hi[..., 2], lo[..., 2])], axis=-1)
                corners.append(transform_point(m, c))
    cs = jnp.stack(corners, axis=0)
    return jnp.min(cs, axis=0), jnp.max(cs, axis=0)


def bounds_intersect_p(o, inv_d, t_max, lo, hi):
    """Robust slab test with tFar inflated by 1 + 2*gamma(3)
    (Bounds3::IntersectP, Shapes.h:100-124). Broadcasts rays against bounds."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    t_near = jnp.minimum(t0, t1)
    t_far = jnp.maximum(t0, t1) * (1.0 + 2.0 * fp_gamma(3))
    # NaNs from 0 * inf (ray parallel, origin on slab) -> treat as pass-through
    t_near = jnp.where(jnp.isnan(t_near), -jnp.inf, t_near)
    t_far = jnp.where(jnp.isnan(t_far), jnp.inf, t_far)
    enter = jnp.max(t_near, axis=-1)
    exit_ = jnp.min(t_far, axis=-1)
    return (enter <= exit_) & (exit_ > 0.0) & (enter < t_max)


# ---------------------------------------------------------------------------
# Surface-interaction record (LocalSurfaceInfo, Shapes.h:144-170)
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SurfaceInfo:
    """Per-ray hit record, SoA over the batch.

    ``n`` is the face-forwarded shading normal (flipped toward ``wo``,
    Shapes.h:1074-1075); ``backface`` records whether that flip happened —
    i.e. the ray struck the geometric back side (it is *exiting* a closed
    shape). Transmission code needs this bit because the flip erases the
    inside/outside information from ``n`` itself."""
    t: jnp.ndarray        # (...,)
    valid: jnp.ndarray    # (...,) bool
    p: jnp.ndarray        # (..., 3) world hit point
    n: jnp.ndarray        # (..., 3) world geometric normal (faces wo)
    uv: jnp.ndarray       # (..., 2)
    dpdu: jnp.ndarray     # (..., 3)
    dpdv: jnp.ndarray     # (..., 3)
    wo: jnp.ndarray       # (..., 3) -ray direction
    backface: jnp.ndarray  # (...,) bool — hit the geometric back side

    def tree_flatten(self):
        return (self.t, self.valid, self.p, self.n, self.uv, self.dpdu,
                self.dpdv, self.wo, self.backface), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


# ---------------------------------------------------------------------------
# Stable quadratic (the reference's PBRT form, Shapes.h:286-298)
# ---------------------------------------------------------------------------

def stable_quadratic(a, b, c):
    """Roots of a t^2 + b t + c with the numerically stable formulation.
    Returns (t0, t1, has_roots) with t0 <= t1."""
    disc = difference_of_products(b, b, 4.0 * a, c)
    has = disc >= 0.0
    root = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = -0.5 * (b + jnp.sign(b) * root)
    q = jnp.where(b == 0.0, -0.5 * root, q)
    safe_a = jnp.where(a == 0.0, 1.0, a)
    safe_q = jnp.where(q == 0.0, 1.0, q)
    t0 = q / safe_a
    t1 = c / safe_q
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    return lo, hi, has


# ---------------------------------------------------------------------------
# Sphere (Shapes.h:209-432): clipped by z∈[zmin,zmax], φ ≤ φmax
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SphereTable:
    """SoA parameters for M spheres."""
    radius: jnp.ndarray        # (M,)
    z_min: jnp.ndarray         # (M,)
    z_max: jnp.ndarray         # (M,)
    phi_max: jnp.ndarray       # (M,)
    o2w: jnp.ndarray           # (M, 4, 4)
    w2o: jnp.ndarray           # (M, 4, 4)

    def tree_flatten(self):
        return (self.radius, self.z_min, self.z_max, self.phi_max,
                self.o2w, self.w2o), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def build(cls, spheres):
        """spheres: list of dicts {radius, z_min, z_max, phi_max, transform}."""
        rad, zmin, zmax, pmax, o2w, w2o = [], [], [], [], [], []
        for s in spheres:
            r = float(s["radius"])
            rad.append(r)
            zmin.append(float(s.get("z_min", -r)))
            zmax.append(float(s.get("z_max", r)))
            pmax.append(float(s.get("phi_max", 2.0 * math.pi)))
            m, mi = s.get("transform") or make_transform()
            o2w.append(m)
            w2o.append(mi)
        f = lambda x: jnp.asarray(np.asarray(x, np.float32))
        return cls(f(rad), f(zmin), f(zmax), f(pmax), f(np.stack(o2w)),
                   f(np.stack(w2o)))


def _phi_of(p, phi_max):
    phi = jnp.arctan2(p[..., 1], p[..., 0])
    return jnp.where(phi < 0.0, phi + 2.0 * math.pi, phi)


def sphere_intersect_t(o, d, t_max, tab: SphereTable):
    """Hit distances (N, M): inf where missed. Matches the reference's
    clip-and-retest-with-t1 semantics (Shapes.h:335-354).

    Computed shape-major — every intermediate is (M, n) with the RAY axis
    minor — instead of broadcasting (N, M, 3) with a 3-wide minor axis
    (same orientation as the triangle-major brute mesh test; per-pair math
    is unchanged)."""
    batch = o.shape[:-1]
    n = int(np.prod(batch)) if batch else 1
    ox, oy, oz = (o.reshape(-1, 3)[:, k] for k in range(3))
    dx, dy, dz = (d.reshape(-1, 3)[:, k] for k in range(3))
    tm = t_max.reshape(-1)

    w2o = tab.w2o                              # (M, 4, 4)
    mc = lambda r, c: w2o[:, r, c][:, None]    # (M, 1)
    oo = tuple(mc(r, 0) * ox + mc(r, 1) * oy + mc(r, 2) * oz + mc(r, 3)
               for r in range(3))              # (M, n) each
    od = tuple(mc(r, 0) * dx + mc(r, 1) * dy + mc(r, 2) * dz
               for r in range(3))
    r = tab.radius[:, None]
    z_min = tab.z_min[:, None]
    z_max = tab.z_max[:, None]
    phi_max = tab.phi_max[:, None]

    a = od[0] * od[0] + od[1] * od[1] + od[2] * od[2]
    b = 2.0 * (od[0] * oo[0] + od[1] * oo[1] + od[2] * oo[2])
    c = oo[0] * oo[0] + oo[1] * oo[1] + oo[2] * oo[2] - r * r
    t0, t1, has = stable_quadratic(a, b, c)

    def clip_ok(t):
        px = oo[0] + od[0] * t
        py = oo[1] + od[1] * t
        pz = oo[2] + od[2] * t
        # hit refinement: project onto the sphere (Shapes.h:327)
        norm = jnp.sqrt(px * px + py * py + pz * pz)
        s = r / jnp.maximum(norm, 1e-20)
        px, py, pz = px * s, py * s, pz * s
        phi = jnp.arctan2(py, px)
        phi = jnp.where(phi < 0.0, phi + 2.0 * math.pi, phi)
        return (pz >= z_min) & (pz <= z_max) & (phi <= phi_max)

    eps = 1e-4 * r   # scale-relative near-t exclusion (spawn offsets do the
    # real self-intersection work; this only rejects same-surface re-hits)
    t0_ok = has & (t0 > eps) & (t0 < tm) & clip_ok(t0)
    t1_ok = has & (t1 > eps) & (t1 < tm) & clip_ok(t1)
    t = jnp.where(t0_ok, t0, jnp.where(t1_ok, t1, jnp.inf))
    return t.T.reshape(batch + (w2o.shape[0],))


def sphere_surface(o, d, t, idx, tab: SphereTable):
    """Full surface info for each ray's winning sphere ``idx`` (N,)."""
    w2o = tab.w2o[idx]
    o2w = tab.o2w[idx]
    r = tab.radius[idx]
    phi_max = tab.phi_max[idx]
    z_min = tab.z_min[idx]
    z_max = tab.z_max[idx]

    oo, od = transform_ray(w2o, o, d)
    p = oo + od * t[..., None]
    p = p * (r / jnp.maximum(jnp.linalg.norm(p, axis=-1), 1e-20))[..., None]
    phi = _phi_of(p, phi_max)
    # θ/φ parameterization (Shapes.h:369-421)
    cos_theta = jnp.clip(p[..., 2] / r, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    theta_min = jnp.arccos(jnp.clip(z_max / r, -1, 1))
    theta_max = jnp.arccos(jnp.clip(z_min / r, -1, 1))
    u = phi / phi_max
    v = (theta - theta_min) / jnp.maximum(theta_max - theta_min, 1e-9)
    z_r = jnp.sqrt(jnp.maximum(p[..., 0] ** 2 + p[..., 1] ** 2, 1e-20))
    cos_phi = p[..., 0] / z_r
    sin_phi = p[..., 1] / z_r
    dpdu = jnp.stack([-phi_max * p[..., 1], phi_max * p[..., 0],
                      jnp.zeros_like(phi)], axis=-1)
    dt = theta_max - theta_min
    dpdv = dt[..., None] * jnp.stack(
        [p[..., 2] * cos_phi, p[..., 2] * sin_phi,
         -r * jnp.sin(theta)], axis=-1)
    n_obj = p / jnp.maximum(jnp.linalg.norm(p, axis=-1, keepdims=True), 1e-20)
    return _finish_surface(o2w, w2o, o, d, t, p, n_obj, u, v, dpdu, dpdv)


def _finish_surface(o2w, w2o, o, d, t, p_obj, n_obj, u, v, dpdu_obj, dpdv_obj):
    pw = transform_point(o2w, p_obj)
    nw = transform_normal(w2o, n_obj)
    nw = nw / jnp.maximum(jnp.linalg.norm(nw, axis=-1, keepdims=True), 1e-20)
    wo = -d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-20)
    # face-forward (normal flipped toward the viewer, Shapes.h:1074-1075);
    # the flip is recorded as `backface` so transmission keeps in/out info.
    flip = jnp.sum(nw * wo, axis=-1, keepdims=True) < 0.0
    nw = jnp.where(flip, -nw, nw)
    return SurfaceInfo(
        t=t, valid=jnp.isfinite(t),
        p=pw, n=nw, uv=jnp.stack([u, v], axis=-1),
        dpdu=transform_vector(o2w, dpdu_obj),
        dpdv=transform_vector(o2w, dpdv_obj), wo=wo,
        backface=flip[..., 0])


# ---------------------------------------------------------------------------
# Cylinder (Shapes.h:434-620): x²+y²=r², z∈[zmin,zmax], φ ≤ φmax
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class CylinderTable:
    radius: jnp.ndarray
    z_min: jnp.ndarray
    z_max: jnp.ndarray
    phi_max: jnp.ndarray
    o2w: jnp.ndarray
    w2o: jnp.ndarray

    def tree_flatten(self):
        return (self.radius, self.z_min, self.z_max, self.phi_max,
                self.o2w, self.w2o), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def build(cls, cylinders):
        rad, zmin, zmax, pmax, o2w, w2o = [], [], [], [], [], []
        for s in cylinders:
            rad.append(float(s["radius"]))
            zmin.append(float(s.get("z_min", -1.0)))
            zmax.append(float(s.get("z_max", 1.0)))
            pmax.append(float(s.get("phi_max", 2.0 * math.pi)))
            m, mi = s.get("transform") or make_transform()
            o2w.append(m)
            w2o.append(mi)
        f = lambda x: jnp.asarray(np.asarray(x, np.float32))
        return cls(f(rad), f(zmin), f(zmax), f(pmax), f(np.stack(o2w)),
                   f(np.stack(w2o)))


def cylinder_intersect_t(o, d, t_max, tab: CylinderTable):
    """Shape-major (M, n) layout — see sphere_intersect_t."""
    batch = o.shape[:-1]
    ox, oy, oz = (o.reshape(-1, 3)[:, k] for k in range(3))
    dx, dy, dz = (d.reshape(-1, 3)[:, k] for k in range(3))
    tm = t_max.reshape(-1)
    w2o = tab.w2o
    mc = lambda rr, cc: w2o[:, rr, cc][:, None]
    oo = tuple(mc(k, 0) * ox + mc(k, 1) * oy + mc(k, 2) * oz + mc(k, 3)
               for k in range(3))
    od = tuple(mc(k, 0) * dx + mc(k, 1) * dy + mc(k, 2) * dz
               for k in range(3))
    r = tab.radius[:, None]
    z_min = tab.z_min[:, None]
    z_max = tab.z_max[:, None]
    phi_max = tab.phi_max[:, None]
    a = od[0] * od[0] + od[1] * od[1]
    b = 2.0 * (od[0] * oo[0] + od[1] * oo[1])
    c = oo[0] * oo[0] + oo[1] * oo[1] - r * r
    t0, t1, has = stable_quadratic(a, b, c)

    def clip_ok(t):
        px = oo[0] + od[0] * t
        py = oo[1] + od[1] * t
        pz = oo[2] + od[2] * t
        # radial refinement (Shapes.h hit refinement pattern)
        hit_r = jnp.sqrt(jnp.maximum(px * px + py * py, 1e-20))
        phi = jnp.arctan2(py, px)
        phi = jnp.where(phi < 0.0, phi + 2.0 * math.pi, phi)
        return ((pz >= z_min) & (pz <= z_max)
                & (phi <= phi_max) & (hit_r > 0))

    eps = 1e-4 * r   # scale-relative (see sphere_intersect_t)
    t0_ok = has & (t0 > eps) & (t0 < tm) & clip_ok(t0)
    t1_ok = has & (t1 > eps) & (t1 < tm) & clip_ok(t1)
    t = jnp.where(t0_ok, t0, jnp.where(t1_ok, t1, jnp.inf))
    return t.T.reshape(batch + (w2o.shape[0],))


def cylinder_surface(o, d, t, idx, tab: CylinderTable):
    w2o = tab.w2o[idx]
    o2w = tab.o2w[idx]
    r = tab.radius[idx]
    phi_max = tab.phi_max[idx]
    z_min = tab.z_min[idx]
    z_max = tab.z_max[idx]
    oo, od = transform_ray(w2o, o, d)
    p = oo + od * t[..., None]
    hit_r = jnp.sqrt(jnp.maximum(p[..., 0] ** 2 + p[..., 1] ** 2, 1e-20))
    # radial hit refinement (Shapes.h pattern)
    p = jnp.stack([p[..., 0] * r / hit_r, p[..., 1] * r / hit_r,
                   p[..., 2]], axis=-1)
    phi = _phi_of(p, phi_max)
    u = phi / phi_max
    v = (p[..., 2] - z_min) / jnp.maximum(z_max - z_min, 1e-9)
    dpdu = jnp.stack([-phi_max * p[..., 1], phi_max * p[..., 0],
                      jnp.zeros_like(u)], axis=-1)
    dpdv = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), p.shape) \
        * (z_max - z_min)[..., None]
    n_obj = jnp.stack([p[..., 0], p[..., 1], jnp.zeros_like(u)], axis=-1)
    n_obj = n_obj / jnp.maximum(jnp.linalg.norm(n_obj, axis=-1, keepdims=True),
                                1e-20)
    return _finish_surface(o2w, w2o, o, d, t, p, n_obj, u, v, dpdu, dpdv)


# ---------------------------------------------------------------------------
# Disk (Shapes.h:622-758): annulus at z=h, inner/outer radius, φ ≤ φmax
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DiskTable:
    height: jnp.ndarray
    radius: jnp.ndarray
    inner_radius: jnp.ndarray
    phi_max: jnp.ndarray
    o2w: jnp.ndarray
    w2o: jnp.ndarray

    def tree_flatten(self):
        return (self.height, self.radius, self.inner_radius, self.phi_max,
                self.o2w, self.w2o), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def build(cls, disks):
        h, rad, irad, pmax, o2w, w2o = [], [], [], [], [], []
        for s in disks:
            h.append(float(s.get("height", 0.0)))
            rad.append(float(s["radius"]))
            irad.append(float(s.get("inner_radius", 0.0)))
            pmax.append(float(s.get("phi_max", 2.0 * math.pi)))
            m, mi = s.get("transform") or make_transform()
            o2w.append(m)
            w2o.append(mi)
        f = lambda x: jnp.asarray(np.asarray(x, np.float32))
        return cls(f(h), f(rad), f(irad), f(pmax), f(np.stack(o2w)),
                   f(np.stack(w2o)))


def disk_intersect_t(o, d, t_max, tab: DiskTable):
    """Shape-major (M, n) layout — see sphere_intersect_t."""
    batch = o.shape[:-1]
    ox, oy, oz = (o.reshape(-1, 3)[:, k] for k in range(3))
    dx, dy, dz3 = (d.reshape(-1, 3)[:, k] for k in range(3))
    tm = t_max.reshape(-1)
    w2o = tab.w2o
    mc = lambda rr, cc: w2o[:, rr, cc][:, None]
    oo = tuple(mc(k, 0) * ox + mc(k, 1) * oy + mc(k, 2) * oz + mc(k, 3)
               for k in range(3))
    od = tuple(mc(k, 0) * dx + mc(k, 1) * dy + mc(k, 2) * dz3
               for k in range(3))
    dz = od[2]
    parallel = jnp.abs(dz) < 1e-9
    t = (tab.height[:, None] - oo[2]) / jnp.where(parallel, 1.0, dz)
    px = oo[0] + od[0] * t
    py = oo[1] + od[1] * t
    r2 = px * px + py * py
    phi = jnp.arctan2(py, px)
    phi = jnp.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    radius = tab.radius[:, None]
    eps = 1e-4 * radius   # scale-relative (see sphere_intersect_t)
    ok = (~parallel & (t > eps) & (t < tm)
          & (r2 <= radius ** 2) & (r2 >= tab.inner_radius[:, None] ** 2)
          & (phi <= tab.phi_max[:, None]))
    t = jnp.where(ok, t, jnp.inf)
    return t.T.reshape(batch + (w2o.shape[0],))


def disk_surface(o, d, t, idx, tab: DiskTable):
    w2o = tab.w2o[idx]
    o2w = tab.o2w[idx]
    radius = tab.radius[idx]
    inner = tab.inner_radius[idx]
    phi_max = tab.phi_max[idx]
    oo, od = transform_ray(w2o, o, d)
    p = oo + od * t[..., None]
    r_hit = jnp.sqrt(jnp.maximum(p[..., 0] ** 2 + p[..., 1] ** 2, 1e-20))
    phi = _phi_of(p, phi_max)
    u = phi / phi_max
    v = (radius - r_hit) / jnp.maximum(radius - inner, 1e-9)
    dpdu = jnp.stack([-phi_max * p[..., 1], phi_max * p[..., 0],
                      jnp.zeros_like(u)], axis=-1)
    dpdv = jnp.stack([p[..., 0], p[..., 1], jnp.zeros_like(u)], axis=-1) \
        * ((inner - radius) / jnp.maximum(r_hit, 1e-9))[..., None]
    n_obj = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), p.shape)
    return _finish_surface(o2w, w2o, o, d, t, p, n_obj, u, v, dpdu, dpdv)
