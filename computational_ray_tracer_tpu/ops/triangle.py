"""Watertight triangle intersection over flattened mesh tensors.

Capability parity with ``RayTracer/Shapes.h:760-1491`` (TriangleSimple's
Cramer's-rule solve, the PBRT watertight Triangle test with conservative
error bounds, barycentric surface interpolation with degenerate-UV fallback,
TriModel grouping with backface culling and model-space AABBs), as array
code:

- a mesh is a set of flat arrays (positions/normals/uvs/tangents/indices);
  per-triangle vertex fetch is a gather, the intersection test itself is
  branch-free elementwise code over (ray, triangle) pairs;
- the watertight algorithm (translate → permute dominant axis → shear →
  signed edge functions) uses an exact-product correction
  (``difference_of_products``) in place of the reference's double-precision
  edge fallback (Shapes.h:1174-1184) — see SURVEY §7 "hard parts";
- hit *counters* (Hitdata::triangle_intersect_count, Shapes.h:909-911) are
  returned as array outputs instead of global mutable state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from computational_ray_tracer_tpu.ops.shapes import (
    SurfaceInfo, difference_of_products, fp_gamma, transform_point,
    transform_vector, transform_normal, make_transform)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class MeshData:
    """Flattened triangle mesh (MeshCache::Mesh capability,
    AssetManager.h:20-41). All arrays are device tensors; `indices` is
    (F, 3) int32. Vertices are stored pre-transformed to world space (the
    TriModel 'precomputed world space' mode, Shapes.h:1483-1491)."""
    positions: jnp.ndarray   # (V, 3)
    normals: jnp.ndarray     # (V, 3)
    uvs: jnp.ndarray         # (V, 2)
    tangents: jnp.ndarray    # (V, 3)
    bitangents: jnp.ndarray  # (V, 3)
    indices: jnp.ndarray     # (F, 3) int32

    def tree_flatten(self):
        return (self.positions, self.normals, self.uvs, self.tangents,
                self.bitangents, self.indices), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def build(cls, positions, indices, normals=None, uvs=None, tangents=None,
              bitangents=None, transform=None):
        """Host-side constructor with missing-attribute defaults
        (AssetManager.cpp:104-191 semantics) and optional world transform."""
        pos = np.asarray(positions, np.float32).reshape(-1, 3)
        idx = np.asarray(indices, np.int32).reshape(-1, 3)
        if transform is not None:
            m = np.asarray(transform[0], np.float32)
            ph = np.concatenate([pos, np.ones_like(pos[:, :1])], axis=1)
            pos = (ph @ m.T)[:, :3]
        if normals is None:
            normals = _vertex_normals(pos, idx)
        else:
            normals = np.asarray(normals, np.float32).reshape(-1, 3)
            if transform is not None:
                mi = np.asarray(transform[1], np.float32)
                normals = normals @ mi[:3, :3]
                nl = np.linalg.norm(normals, axis=1, keepdims=True)
                normals = normals / np.maximum(nl, 1e-12)
        if uvs is None:
            uvs = np.zeros((pos.shape[0], 2), np.float32)
        else:
            uvs = np.asarray(uvs, np.float32).reshape(-1, 2)
        if tangents is None:
            tangents = _default_frame(normals)
        else:
            tangents = np.asarray(tangents, np.float32).reshape(-1, 3)
        if bitangents is None:
            bitangents = np.cross(normals, tangents)
        else:
            bitangents = np.asarray(bitangents, np.float32).reshape(-1, 3)
        obj = cls(jnp.asarray(pos), jnp.asarray(normals), jnp.asarray(uvs),
                  jnp.asarray(tangents), jnp.asarray(bitangents),
                  jnp.asarray(idx))
        # Host copies for the build-time consumers (octree builders, the
        # world-radius bound), which would otherwise copy the mesh back
        # from the device. A plain attribute, NOT part of the pytree —
        # instances that have round-tripped through jit lose it and
        # callers must fall back.
        obj._host = (pos, idx)
        return obj

    @property
    def n_triangles(self):
        return self.indices.shape[0]

    def triangle_vertices(self, tri_idx):
        """(..., 3) triangle ids -> three (..., 3) vertex positions."""
        i = self.indices[tri_idx]
        return (self.positions[i[..., 0]], self.positions[i[..., 1]],
                self.positions[i[..., 2]])

    def bounds(self):
        lo = jnp.min(self.positions, axis=0)
        hi = jnp.max(self.positions, axis=0)
        return lo, hi


def _vertex_normals(pos, idx):
    """Area-weighted vertex normals (GenNormals capability)."""
    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    vn = np.zeros_like(pos)
    for k in range(3):
        np.add.at(vn, idx[:, k], fn)
    ln = np.linalg.norm(vn, axis=1, keepdims=True)
    return (vn / np.maximum(ln, 1e-12)).astype(np.float32)


def _default_frame(normals):
    """Arbitrary tangent frame for meshes without UVs (the degenerate-UV
    fallback of Shapes.h:1030-1044)."""
    n = normals
    a = np.where(np.abs(n[:, :1]) > 0.9,
                 np.asarray([[0.0, 1.0, 0.0]]), np.asarray([[1.0, 0.0, 0.0]]))
    t = np.cross(a, n)
    ln = np.linalg.norm(t, axis=1, keepdims=True)
    return (t / np.maximum(ln, 1e-12)).astype(np.float32)


# ---------------------------------------------------------------------------
# Watertight ray-triangle test (Shapes.h:1101-1260 capability)
# ---------------------------------------------------------------------------

def triangle_intersect(o, d, t_max, p0, p1, p2):
    """Watertight intersection of rays against triangles (broadcast pairs).

    Inputs broadcast: o/d (..., 3), t_max (...), p0/p1/p2 (..., 3).
    Returns (t, b0, b1, b2, hit): distance (inf on miss) + barycentrics.

    Algorithm: translate to ray origin, permute so |d| is largest on z,
    shear to unit +z, signed 2D edge functions with exact-product
    correction, det/tScaled sign tests, conservative error bound on t
    (gamma-based, replacing the reference's double fallback).
    """
    # Translate
    a = p0 - o
    b = p1 - o
    c = p2 - o

    # Permutation: kz = argmax |d|; kx, ky cyclic
    ad = jnp.abs(d)
    kz = jnp.argmax(ad, axis=-1)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3

    def permute(v, i0, i1, i2):
        return jnp.stack([jnp.take_along_axis(v, i0[..., None], axis=-1)[..., 0],
                          jnp.take_along_axis(v, i1[..., None], axis=-1)[..., 0],
                          jnp.take_along_axis(v, i2[..., None], axis=-1)[..., 0]],
                         axis=-1)

    dp = permute(d, kx, ky, kz)
    ap = permute(a, kx, ky, kz)
    bp = permute(b, kx, ky, kz)
    cp = permute(c, kx, ky, kz)

    # Shear to align the ray with +z
    inv_dz = 1.0 / dp[..., 2]
    sx = -dp[..., 0] * inv_dz
    sy = -dp[..., 1] * inv_dz
    sz = inv_dz

    ax = ap[..., 0] + sx * ap[..., 2]
    ay = ap[..., 1] + sy * ap[..., 2]
    bx = bp[..., 0] + sx * bp[..., 2]
    by = bp[..., 1] + sy * bp[..., 2]
    cx = cp[..., 0] + sx * cp[..., 2]
    cy = cp[..., 1] + sy * cp[..., 2]

    # Signed edge functions with exact-product correction
    e0 = difference_of_products(bx, cy, by, cx)
    e1 = difference_of_products(cx, ay, cy, ax)
    e2 = difference_of_products(ax, by, ay, bx)

    same_side = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | \
                ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
    det = e0 + e1 + e2
    nonzero = det != 0.0

    az = sz * ap[..., 2]
    bz = sz * bp[..., 2]
    cz = sz * cp[..., 2]
    t_scaled = e0 * az + e1 * bz + e2 * cz

    # sign-consistent distance test: 0 < t < t_max (scaled by det sign)
    neg_det = det < 0
    ts = jnp.where(neg_det, -t_scaled, t_scaled)
    dd = jnp.abs(det)
    in_range = (ts > 0.0) & (ts < t_max * dd)

    inv_det = 1.0 / jnp.where(nonzero, det, 1.0)
    b0 = e0 * inv_det
    b1 = e1 * inv_det
    b2 = e2 * inv_det
    t = t_scaled * inv_det

    # Conservative error bound on t (Shapes.h:1226-1256 capability)
    max_z = jnp.maximum(jnp.maximum(jnp.abs(az), jnp.abs(bz)), jnp.abs(cz))
    delta_z = fp_gamma(3) * max_z
    max_x = jnp.maximum(jnp.maximum(jnp.abs(ax), jnp.abs(bx)), jnp.abs(cx))
    max_y = jnp.maximum(jnp.maximum(jnp.abs(ay), jnp.abs(by)), jnp.abs(cy))
    delta_x = fp_gamma(5) * (max_x + max_z)
    delta_y = fp_gamma(5) * (max_y + max_z)
    delta_e = 2.0 * (fp_gamma(2) * max_x * max_y
                     + delta_y * max_x + delta_x * max_y)
    max_e = jnp.maximum(jnp.maximum(jnp.abs(e0), jnp.abs(e1)), jnp.abs(e2))
    delta_t = 3.0 * (fp_gamma(3) * max_e * max_z + delta_e * max_z
                     + delta_z * max_e) * jnp.abs(inv_det)
    hit = same_side & nonzero & in_range & (t > delta_t)

    return jnp.where(hit, t, jnp.inf), b0, b1, b2, hit


def _triangle_intersect_tri_major(o, d, t_max, p0, p1, p2, tri_mask=None):
    """Watertight test in triangle-major SoA layout: rays (n,) on the minor
    axis, triangles (F, 1) broadcast on the major axis -> every
    intermediate is (F, n), contiguous along the rays.

    Unlike the generic ``triangle_intersect`` broadcast orientation (n, F),
    the permutation is a mask-select (three ``where``s) instead of a
    per-element ``take_along_axis``. Math per (ray, tri) pair is identical
    to ``triangle_intersect`` (same ops incl. DifferenceOfProducts + gamma
    t-bound), so results match to fusion-rounding noise.

    Returns (t_best (n,), j_best (n,) int32 in [0, F), b1, b2)."""
    batch = o.shape[:-1]
    n = int(np.prod(batch)) if batch else 1
    ox, oy, oz = (o.reshape(-1, 3)[:, k] for k in range(3))
    dx, dy, dz = (d.reshape(-1, 3)[:, k] for k in range(3))
    tm = t_max.reshape(-1)

    adx, ady, adz = jnp.abs(dx), jnp.abs(dy), jnp.abs(dz)
    kz_x = (adx >= ady) & (adx >= adz)
    kz_y = (~kz_x) & (ady >= adz)

    def perm(vx, vy, vz):
        pz = jnp.where(kz_x, vx, jnp.where(kz_y, vy, vz))
        px = jnp.where(kz_x, vy, jnp.where(kz_y, vz, vx))
        py = jnp.where(kz_x, vz, jnp.where(kz_y, vx, vy))
        return px, py, pz

    dxp, dyp, dzp = perm(dx, dy, dz)
    inv_dz = 1.0 / dzp
    sx = -dxp * inv_dz
    sy = -dyp * inv_dz

    tcol = lambda v, k: v[:, k][:, None]         # (F, 1)

    def sheared(p):
        vx = tcol(p, 0) - ox
        vy = tcol(p, 1) - oy
        vz = tcol(p, 2) - oz
        px, py, pz = perm(vx, vy, vz)
        return px + sx * pz, py + sy * pz, pz

    ax, ay, azp = sheared(p0)
    bx, by, bzp = sheared(p1)
    cx, cy, czp = sheared(p2)

    e0 = difference_of_products(bx, cy, by, cx)
    e1 = difference_of_products(cx, ay, cy, ax)
    e2 = difference_of_products(ax, by, ay, bx)

    same_side = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | \
                ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
    det = e0 + e1 + e2
    nonzero = det != 0.0

    az = inv_dz * azp
    bz = inv_dz * bzp
    cz = inv_dz * czp
    t_scaled = e0 * az + e1 * bz + e2 * cz

    ts = jnp.where(det < 0, -t_scaled, t_scaled)
    dd = jnp.abs(det)
    in_range = (ts > 0.0) & (ts < tm * dd)

    inv_det = 1.0 / jnp.where(nonzero, det, 1.0)
    t = t_scaled * inv_det

    max_z = jnp.maximum(jnp.maximum(jnp.abs(az), jnp.abs(bz)), jnp.abs(cz))
    delta_z = fp_gamma(3) * max_z
    max_x = jnp.maximum(jnp.maximum(jnp.abs(ax), jnp.abs(bx)), jnp.abs(cx))
    max_y = jnp.maximum(jnp.maximum(jnp.abs(ay), jnp.abs(by)), jnp.abs(cy))
    delta_x = fp_gamma(5) * (max_x + max_z)
    delta_y = fp_gamma(5) * (max_y + max_z)
    delta_e = 2.0 * (fp_gamma(2) * max_x * max_y
                     + delta_y * max_x + delta_x * max_y)
    max_e = jnp.maximum(jnp.maximum(jnp.abs(e0), jnp.abs(e1)), jnp.abs(e2))
    delta_t = 3.0 * (fp_gamma(3) * max_e * max_z + delta_e * max_z
                     + delta_z * max_e) * jnp.abs(inv_det)
    hit = same_side & nonzero & in_range & (t > delta_t)
    if tri_mask is not None:
        hit = hit & tri_mask[:, None]
    t = jnp.where(hit, t, jnp.inf)                # (F, n)

    j = jnp.argmin(t, axis=0)                     # (n,)
    t_best = jnp.min(t, axis=0)
    at_min = (jax.lax.broadcasted_iota(jnp.int32, t.shape, 0) == j[None])
    b1_best = jnp.sum(jnp.where(at_min, e1 * inv_det, 0.0), axis=0)
    b2_best = jnp.sum(jnp.where(at_min, e2 * inv_det, 0.0), axis=0)
    return (t_best.reshape(batch), j.astype(jnp.int32).reshape(batch),
            b1_best.reshape(batch), b2_best.reshape(batch))


def simple_triangle_intersect(o, d, t_max, p0, p1, p2):
    """The Cramer's-rule (Shirley-style) solve of TriangleSimple
    (Shapes.h:830-869): kept for parity/testing; same signature as the
    watertight kernel."""
    e1 = p1 - p0
    e2 = p2 - p0
    s = o - p0
    den = jnp.sum(jnp.cross(d, e2) * e1, axis=-1)
    ok = jnp.abs(den) > 1e-12
    inv = 1.0 / jnp.where(ok, den, 1.0)
    beta = jnp.sum(jnp.cross(d, e2) * s, axis=-1) * inv
    gamma = jnp.sum(jnp.cross(s, e1) * d, axis=-1) * inv
    t = jnp.sum(jnp.cross(s, e1) * e2, axis=-1) * inv
    hit = ok & (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1) \
        & (t > 1e-4) & (t < t_max)
    b1, b2 = beta, gamma
    return jnp.where(hit, t, jnp.inf), 1.0 - b1 - b2, b1, b2, hit


# ---------------------------------------------------------------------------
# Brute-force mesh intersection (TriModel::Intersect, Shapes.h:1414-1471)
# ---------------------------------------------------------------------------

def mesh_intersect_brute(o, d, t_max, mesh: MeshData, tri_mask=None,
                         chunk=None):
    """Closest hit of each ray against *all* triangles (the reference's
    brute-force TriModel path). Returns (t, tri_idx, b1, b2, count).

    ``tri_mask`` (F,) optionally disables triangles (the backface-cull mask,
    ComputeBackFace Shapes.h:1339-1380). ``chunk`` processes triangles in
    fixed-size chunks via lax.scan to bound memory for big meshes.
    """
    f = mesh.n_triangles
    i = mesh.indices
    p0 = mesh.positions[i[:, 0]]
    p1 = mesh.positions[i[:, 1]]
    p2 = mesh.positions[i[:, 2]]

    def run_block(p0b, p1b, p2b, maskb, t_cur):
        # triangle-major (F, n) layout (see _triangle_intersect_tri_major)
        return _triangle_intersect_tri_major(o, d, t_cur, p0b, p1b, p2b,
                                             tri_mask=maskb)

    if chunk is None or chunk >= f:
        tbest, j, b1b, b2b = run_block(p0, p1, p2, tri_mask, t_max)
        count = jnp.full(o.shape[:-1], f, jnp.int32)
        return tbest, j.astype(jnp.int32), b1b, b2b, count

    # Chunked scan for large meshes
    pad = (-f) % chunk
    def padded(x, fill):
        return jnp.concatenate(
            [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)], axis=0)
    p0p, p1p, p2p = padded(p0, 0.0), padded(p1, 0.0), padded(p2, 0.0)
    maskp = padded(tri_mask if tri_mask is not None
                   else jnp.ones((f,), bool), False)
    n_blocks = (f + pad) // chunk
    p0c = p0p.reshape(n_blocks, chunk, 3)
    p1c = p1p.reshape(n_blocks, chunk, 3)
    p2c = p2p.reshape(n_blocks, chunk, 3)
    mc = maskp.reshape(n_blocks, chunk)

    def body(carry, blk):
        t_cur, j_cur, b1c, b2c, base = carry
        p0b, p1b, p2b, mb = blk
        tb, jb, b1b, b2b = run_block(p0b, p1b, p2b, mb, t_cur)
        better = tb < t_cur
        carry = (jnp.where(better, tb, t_cur),
                 jnp.where(better, base + jb.astype(jnp.int32), j_cur),
                 jnp.where(better, b1b, b1c),
                 jnp.where(better, b2b, b2c),
                 base + chunk)
        return carry, None

    init = (t_max, jnp.full(o.shape[:-1], -1, jnp.int32),
            jnp.zeros(o.shape[:-1]), jnp.zeros(o.shape[:-1]),
            jnp.int32(0))
    (tb, jb, b1b, b2b, _), _ = jax.lax.scan(body, init, (p0c, p1c, p2c, mc))
    count = jnp.full(o.shape[:-1], f, jnp.int32)
    return jnp.where(jnp.isfinite(tb), tb, jnp.inf), jb, b1b, b2b, count


def mesh_anyhit_brute(o, d, t_max, mesh: MeshData, tri_mask=None):
    """Boolean any-hit against all triangles (IntersectP capability): skips
    the argmin/winner extraction the shadow ray doesn't need."""
    i = mesh.indices
    p0 = mesh.positions[i[:, 0]]
    p1 = mesh.positions[i[:, 1]]
    p2 = mesh.positions[i[:, 2]]
    t, _, _, _ = _triangle_intersect_tri_major(o, d, t_max, p0, p1, p2,
                                               tri_mask=tri_mask)
    return jnp.isfinite(t)


def compute_backface_mask(mesh: MeshData, look_dir):
    """Per-face visibility vs a look direction (ComputeBackFace,
    Shapes.h:1339-1380): True = keep (front-facing)."""
    i = mesh.indices
    p0 = mesh.positions[i[:, 0]]
    p1 = mesh.positions[i[:, 1]]
    p2 = mesh.positions[i[:, 2]]
    fn = jnp.cross(p1 - p0, p2 - p0)
    return jnp.sum(fn * jnp.asarray(look_dir), axis=-1) < 0.0


# ---------------------------------------------------------------------------
# Surface interpolation (Triangle::CalculateLocalSurface, Shapes.h:982-1083)
# ---------------------------------------------------------------------------

def mesh_surface(o, d, t, tri_idx, b1, b2, mesh: MeshData):
    """Barycentric surface info at mesh hits (vectorized gather + lerp)."""
    b0 = 1.0 - b1 - b2
    safe_idx = jnp.maximum(tri_idx, 0)
    i = mesh.indices[safe_idx]

    def lerp3(attr):
        return (b0[..., None] * attr[i[..., 0]]
                + b1[..., None] * attr[i[..., 1]]
                + b2[..., None] * attr[i[..., 2]])

    p = lerp3(mesh.positions)
    n = lerp3(mesh.normals)
    uv = lerp3(mesh.uvs)
    dpdu = lerp3(mesh.tangents)
    dpdv = lerp3(mesh.bitangents)
    p0, p1, p2 = mesh.triangle_vertices(safe_idx)

    nl = jnp.linalg.norm(n, axis=-1, keepdims=True)
    # Degenerate shading normal -> geometric normal fallback
    ng = jnp.cross(p1 - p0, p2 - p0)
    ng = ng / jnp.maximum(jnp.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
    n = jnp.where(nl > 1e-8, n / jnp.maximum(nl, 1e-20), ng)

    wo = -d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-20)
    # In/out from the GEOMETRIC normal (winding), not the shading normal: at
    # silhouettes the interpolated normal can disagree with the side the ray
    # actually struck, and transmission eta selection must follow geometry.
    backface = jnp.sum(ng * wo, axis=-1) < 0.0
    flip = jnp.sum(n * wo, axis=-1, keepdims=True) < 0.0
    n = jnp.where(flip, -n, n)
    return SurfaceInfo(t=t, valid=jnp.isfinite(t) & (tri_idx >= 0), p=p, n=n,
                       uv=uv, dpdu=dpdu, dpdv=dpdv, wo=wo, backface=backface)
