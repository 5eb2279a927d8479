"""Scene description and unified intersection.

The reference has *no scene file format* — scenes are hard-coded app locals
(``RayTracerTestApp.h:103-207``). Here a Scene is a pytree of typed shape
tables (spheres/cylinders/disks), an optional triangle mesh + octree, a
material table, a light table, and an optional texture — replicated across
devices under sharding (SURVEY §2.6 plan).

``scene_intersect`` is the wavefront analog of ``Octtree_Model::Traverse`` +
virtual ``Shape::Intersect`` dispatch: every shape type computes hit
distances for the whole ray batch, a single argmin picks winners, and
surface info is evaluated only for winning (ray, type) pairs then merged
with ``where`` masks. ``scene_occluded`` is the shadow-ray predicate
(IntersectP capability)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from computational_ray_tracer_tpu.ops import shapes as shp
from computational_ray_tracer_tpu.ops import triangle as trimod
from computational_ray_tracer_tpu.ops import octree as octmod
from computational_ray_tracer_tpu.ops import traversal
from computational_ray_tracer_tpu.models.materials import MaterialTable
from computational_ray_tracer_tpu.models.lights import LightTable


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Scene:
    spheres: Optional[shp.SphereTable]
    cylinders: Optional[shp.CylinderTable]
    disks: Optional[shp.DiskTable]
    mesh: Optional[trimod.MeshData]
    octree: Optional[octmod.Octree]
    materials: MaterialTable
    lights: LightTable
    # material id per shape instance, per type
    sphere_mat: Optional[jnp.ndarray]
    cylinder_mat: Optional[jnp.ndarray]
    disk_mat: Optional[jnp.ndarray]
    mesh_tri_mat: Optional[jnp.ndarray]   # (F,) material per triangle
    texture: Optional[jnp.ndarray]        # (Ht, Wt, 3) sigmoid coeffs image
    tri_mask: Optional[jnp.ndarray]       # (F,) backface-cull keep mask
    wr: float = 100.0                     # static world radius (aux data)
    has_rough: bool = True                # any GGX materials (static; gates
                                          # the glossy-lobe work in BSDFs)

    _FIELDS = ("spheres", "cylinders", "disks", "mesh", "octree",
               "materials", "lights", "sphere_mat",
               "cylinder_mat", "disk_mat", "mesh_tri_mat", "texture",
               "tri_mask")

    def tree_flatten(self):
        return (tuple(getattr(self, f) for f in self._FIELDS),
                (self.wr, self.has_rough))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, wr=aux[0], has_rough=aux[1])

    @classmethod
    def build(cls, materials, lights, spheres=None, cylinders=None,
              disks=None, mesh=None, use_octree=True, texture_rgb=None,
              backface_cull_dir=None, octree_capacity=None):
        """Host-side scene assembly. Shape dicts carry a `material` index.

        texture_rgb: (H, W, 3) linear RGB image — pre-converted to sigmoid
        coefficients via the rgb2spec table so per-hit texture lookups are a
        gather (no per-sample fitting)."""
        def tab(builder, items):
            if not items:
                return None, None
            mat_ids = jnp.asarray([int(s.get("material", 0)) for s in items],
                                  jnp.int32)
            return builder(items), mat_ids

        sph, sph_m = tab(shp.SphereTable.build, spheres)
        cyl, cyl_m = tab(shp.CylinderTable.build, cylinders)
        dsk, dsk_m = tab(shp.DiskTable.build, disks)

        tree = None
        tri_mat = None
        tri_mask = None
        if mesh is not None:
            mesh_data, tri_mat = mesh if isinstance(mesh, tuple) else (mesh, None)
            if tri_mat is None:
                tri_mat = jnp.zeros((mesh_data.n_triangles,), jnp.int32)
            if backface_cull_dir is not None:
                tri_mask = trimod.compute_backface_mask(mesh_data,
                                                        backface_cull_dir)
            if use_octree:
                cap = (octree_capacity if octree_capacity is not None
                       else octmod.TRIANGLE_CAPACITY)
                tree = octmod.build_octree(mesh_data, capacity=cap)
            mesh = mesh_data

        tex = None
        if texture_rgb is not None:
            from computational_ray_tracer_tpu.ops import color as colorlib
            img = jnp.asarray(np.asarray(texture_rgb, np.float32))
            h, w, _ = img.shape
            table = colorlib.RGBToSpectrumTable.srgb()
            tex = table.lookup(img.reshape(-1, 3)).reshape(h, w, 3)

        mats = (materials if isinstance(materials, MaterialTable)
                else MaterialTable.build(materials))
        lts = (lights if isinstance(lights, LightTable)
               else LightTable.build(lights))

        # Static world radius (host-side, at build time): conservative bound
        # used for "infinite" distant/ambient shadow rays. Uses the host
        # mesh stash, which the octree build reads too.
        r = 1.0
        if mesh is not None:
            pos_np, _ = octmod.host_mesh_arrays(mesh)
            r = max(r, float(np.abs(pos_np).max()))
        for t in (sph, cyl, dsk):
            if t is not None:
                r = max(r, float(jnp.max(jnp.abs(t.o2w[:, :3, 3]))) +
                        float(jnp.max(jnp.abs(t.radius))))
        from computational_ray_tracer_tpu.models.materials import (
            ROUGH_CONDUCTOR)
        has_rough = bool(np.any(np.asarray(mats.kind) == ROUGH_CONDUCTOR))
        return cls(sph, cyl, dsk, mesh, tree, mats, lts, sph_m,
                   cyl_m, dsk_m, tri_mat, tex, tri_mask, wr=10.0 * r,
                   has_rough=has_rough)

    def world_radius(self):
        """Conservative scene bounding radius (static; safe under jit)."""
        return self.wr


# Shape-type tags in the winner encoding
TYPE_NONE, TYPE_SPHERE, TYPE_CYLINDER, TYPE_DISK, TYPE_MESH = 0, 1, 2, 3, 4


def radix_order(key, n_bits=15, bits_per_pass=4):
    """Stable ascending argsort of small-range non-negative int32 keys via
    LSD radix passes built from cumsum + scatter.

    Semantically identical to ``jnp.argsort(key, stable=True)`` for keys in
    [0, 2^n_bits), built from plain cumsum/gather/scatter HLOs to keep
    ``lax.sort`` of a 262k wavefront out of the compile. Whether it still
    beats ``lax.sort`` on the GPU is not measured yet."""
    n = key.shape[0]
    r = 1 << bits_per_pass
    perm = jnp.arange(n, dtype=jnp.int32)
    k = key.astype(jnp.int32)
    for shift in range(0, n_bits, bits_per_pass):
        digit = (k >> shift) & (r - 1)                     # (N,)
        onehot = (digit[:, None] == jnp.arange(r, dtype=jnp.int32))
        oh32 = onehot.astype(jnp.int32)
        within = jnp.cumsum(oh32, axis=0) - 1              # rank among digit
        counts = within[-1] + 1                            # (r,)
        offsets = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                   jnp.cumsum(counts)[:-1]])
        rank = jnp.sum(jnp.where(onehot, within, 0), axis=1)
        pos = offsets[digit] + rank
        perm = jnp.zeros((n,), jnp.int32).at[pos].set(perm)
        k = jnp.zeros((n,), jnp.int32).at[pos].set(k)
    return perm


def _packet_order(o, d, alive):
    """Sort permutation grouping rays by (direction octant, 8^3 Morton
    cell of origin), dead rays last: the order of the compacted bounce
    loop, which keeps neighbouring rays on neighbouring subtrees."""
    octant = ((d[..., 0] < 0) * 4 + (d[..., 1] < 0) * 2
              + (d[..., 2] < 0)).astype(jnp.int32)
    lo = jnp.min(jnp.where(alive[..., None], o, jnp.inf), axis=0)
    hi = jnp.max(jnp.where(alive[..., None], o, -jnp.inf), axis=0)
    q = jnp.clip(((o - lo) / jnp.maximum(hi - lo, 1e-20) * 8.0)
                 .astype(jnp.int32), 0, 7)

    def spread3(v):
        v = (v | (v << 4)) & 0x0C3
        return (v | (v << 2)) & 0x249

    morton = spread3(q[..., 0]) | (spread3(q[..., 1]) << 1) \
        | (spread3(q[..., 2]) << 2)
    # Compaction correctness depends on dead rays sorting strictly LAST:
    # select() slices the first `bucket` rows, so every key (alive max
    # 7*512+511 = 4095, dead sentinel 1<<14) must fit radix_order's
    # default n_bits — widening octant/Morton bits without widening the
    # radix would silently drop alive rays from buckets.
    _DEAD_KEY = 1 << 14
    _MAX_ALIVE_KEY = 7 * 512 + 511
    assert _MAX_ALIVE_KEY < _DEAD_KEY < (1 << 15), \
        "packet-order keys overflow radix_order(n_bits=15)"
    key = jnp.where(alive, octant * 512 + morton, jnp.int32(_DEAD_KEY))
    return radix_order(key)


def _mesh_closest_hit(scene, o, d, t_best):
    if scene.octree is not None:
        return traversal.closest_hit(o, d, t_best, scene.octree, scene.mesh,
                                     scene.tri_mask)
    return trimod.mesh_intersect_brute(o, d, t_best, scene.mesh,
                                       scene.tri_mask)


def scene_intersect(scene: Scene, o, d, t_max):
    """Closest hit across all shape types.

    Returns (si: SurfaceInfo, mat_id (,...) int32, tri_tests (...,) int32).
    """
    hit = scene_intersect_t(scene, o, d, t_max)
    si, mat_id = scene_surface(scene, o, d, hit)
    return si, mat_id, hit[5]


def scene_intersect_t(scene: Scene, o, d, t_max):
    """Hit-distance phase only: (t_best, type_best, idx_best, b1, b2,
    tri_tests). Lets the integrator batch continuation + shadow rays into
    ONE intersection launch and evaluate surface info only for the
    continuation half (shadow rays need just ``type_best != TYPE_NONE``)."""
    t_best = t_max
    type_best = jnp.zeros(o.shape[:-1], jnp.int32)
    idx_best = jnp.zeros(o.shape[:-1], jnp.int32)
    tri_tests = jnp.zeros(o.shape[:-1], jnp.int32)
    b1 = jnp.zeros(o.shape[:-1])
    b2 = jnp.zeros(o.shape[:-1])

    def fold(t_all, type_tag, t_best, type_best, idx_best):
        # min + argmin (vectorized reduces) — no take_along_axis gather.
        j = jnp.argmin(t_all, axis=-1)
        tb = jnp.min(t_all, axis=-1)
        better = tb < t_best
        return (jnp.where(better, tb, t_best),
                jnp.where(better, type_tag, type_best),
                jnp.where(better, j.astype(jnp.int32), idx_best), better)

    if scene.spheres is not None:
        t_all = shp.sphere_intersect_t(o, d, t_best, scene.spheres)
        t_best, type_best, idx_best, _ = fold(t_all, TYPE_SPHERE, t_best,
                                              type_best, idx_best)
    if scene.cylinders is not None:
        t_all = shp.cylinder_intersect_t(o, d, t_best, scene.cylinders)
        t_best, type_best, idx_best, _ = fold(t_all, TYPE_CYLINDER, t_best,
                                              type_best, idx_best)
    if scene.disks is not None:
        t_all = shp.disk_intersect_t(o, d, t_best, scene.disks)
        t_best, type_best, idx_best, _ = fold(t_all, TYPE_DISK, t_best,
                                              type_best, idx_best)
    if scene.mesh is not None:
        tm, ti, mb1, mb2, tests = _mesh_closest_hit(scene, o, d, t_best)
        tri_tests = tri_tests + tests
        better = tm < t_best
        t_best = jnp.where(better, tm, t_best)
        type_best = jnp.where(better, TYPE_MESH, type_best)
        idx_best = jnp.where(better, ti, idx_best)
        b1 = jnp.where(better, mb1, b1)
        b2 = jnp.where(better, mb2, b2)

    return t_best, type_best, idx_best, b1, b2, tri_tests


def scene_surface(scene: Scene, o, d, hit):
    """Surface-info phase: evaluate SurfaceInfo + material id for the
    winners of ``scene_intersect_t``."""
    t_best, type_best, idx_best, b1, b2, _ = hit
    valid = jnp.isfinite(t_best) & (type_best != TYPE_NONE)
    t_hit = jnp.where(valid, t_best, jnp.inf)

    # Surface info for winners, merged across types.
    si = _empty_surface(o, d, t_hit)
    mat_id = jnp.zeros(o.shape[:-1], jnp.int32)

    def merge(si, si_new, mask):
        mask_v = mask[..., None]
        return shp.SurfaceInfo(
            t=jnp.where(mask, si_new.t, si.t),
            valid=jnp.where(mask, si_new.valid, si.valid),
            p=jnp.where(mask_v, si_new.p, si.p),
            n=jnp.where(mask_v, si_new.n, si.n),
            uv=jnp.where(mask_v, si_new.uv, si.uv),
            dpdu=jnp.where(mask_v, si_new.dpdu, si.dpdu),
            dpdv=jnp.where(mask_v, si_new.dpdv, si.dpdv),
            wo=jnp.where(mask_v, si_new.wo, si.wo),
            backface=jnp.where(mask, si_new.backface, si.backface))

    t_for_surf = jnp.where(valid, t_best, 1.0)
    if scene.spheres is not None:
        m = valid & (type_best == TYPE_SPHERE)
        s = shp.sphere_surface(o, d, t_for_surf, idx_best, scene.spheres)
        si = merge(si, s, m)
        mat_id = jnp.where(m, scene.sphere_mat[idx_best], mat_id)
    if scene.cylinders is not None:
        m = valid & (type_best == TYPE_CYLINDER)
        s = shp.cylinder_surface(o, d, t_for_surf, idx_best, scene.cylinders)
        si = merge(si, s, m)
        mat_id = jnp.where(m, scene.cylinder_mat[idx_best], mat_id)
    if scene.disks is not None:
        m = valid & (type_best == TYPE_DISK)
        s = shp.disk_surface(o, d, t_for_surf, idx_best, scene.disks)
        si = merge(si, s, m)
        mat_id = jnp.where(m, scene.disk_mat[idx_best], mat_id)
    if scene.mesh is not None:
        m = valid & (type_best == TYPE_MESH)
        s = trimod.mesh_surface(o, d, t_for_surf, idx_best, b1, b2,
                                scene.mesh)
        si = merge(si, s, m)
        mat_id = jnp.where(m, scene.mesh_tri_mat[jnp.maximum(idx_best, 0)],
                           mat_id)

    si = shp.SurfaceInfo(t=t_hit, valid=valid, p=si.p, n=si.n, uv=si.uv,
                         dpdu=si.dpdu, dpdv=si.dpdv, wo=si.wo,
                         backface=si.backface)
    return si, mat_id


def _empty_surface(o, d, t):
    z3 = jnp.zeros_like(o)
    return shp.SurfaceInfo(
        t=t, valid=jnp.zeros(o.shape[:-1], bool), p=z3,
        n=jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), o.shape),
        uv=jnp.zeros(o.shape[:-1] + (2,)), dpdu=z3, dpdv=z3,
        wo=-d, backface=jnp.zeros(o.shape[:-1], bool))


def scene_anyhit(scene: Scene, o, d, t_max):
    """Boolean any-hit test (Shape::IntersectP capability): does ANY shape
    intersect in (0, t_max)? Skips all the closest-hit machinery the shadow
    ray doesn't need — no winner argmin, no surface-info gathers (~2x less
    work than scene_intersect on the NEE path)."""
    hit = jnp.zeros(o.shape[:-1], bool)
    if scene.spheres is not None:
        t_all = shp.sphere_intersect_t(o, d, t_max, scene.spheres)
        hit = hit | jnp.any(t_all < t_max[..., None], axis=-1)
    if scene.cylinders is not None:
        t_all = shp.cylinder_intersect_t(o, d, t_max, scene.cylinders)
        hit = hit | jnp.any(t_all < t_max[..., None], axis=-1)
    if scene.disks is not None:
        t_all = shp.disk_intersect_t(o, d, t_max, scene.disks)
        hit = hit | jnp.any(t_all < t_max[..., None], axis=-1)
    if scene.mesh is not None:
        # Shrink t_max for already-occluded rays to 0 so the traversal
        # skips them.
        t_m = jnp.where(hit, 0.0, t_max)
        if scene.octree is not None:
            hit = hit | traversal.any_hit(o, d, t_m, scene.octree,
                                          scene.mesh, scene.tri_mask)
        else:
            hit = hit | trimod.mesh_anyhit_brute(o, d, t_m, scene.mesh,
                                                 scene.tri_mask)
    return hit


def scene_occluded(scene: Scene, p, wi, dist, eps=1e-3, n=None):
    """Shadow-ray predicate: is anything between p and p + wi*dist?

    ``eps`` may be per-ray (scale-aware spawn offsets, see
    integrator.spawn_eps). With ``n`` given, the origin is offset along the
    surface normal (signed toward wi's hemisphere) — more robust than
    offsetting along a grazing wi (the reference's per-hit FP error-bound
    intent, Shapes.h:1226-1256)."""
    eps = jnp.broadcast_to(jnp.asarray(eps), p.shape[:-1])
    if n is None:
        o = p + wi * eps[..., None]
    else:
        s = jnp.sign(jnp.sum(wi * n, axis=-1))
        o = p + n * (s * eps)[..., None]
    # end the ray just short of the light: relative shrink (survives scene
    # scaling) plus the spawn offset
    t_max = dist * (1.0 - 1e-3) - eps
    return scene_anyhit(scene, o, wi, t_max)


def texture_lookup(texture, uv):
    """Bilinear fetch of sigmoid coefficients from the texture image
    (the stbi uvmap fetch, RayTracerTestApp.h:252-259)."""
    h, w, _ = texture.shape
    x = jnp.clip(uv[..., 0], 0.0, 1.0) * (w - 1)
    y = jnp.clip(1.0 - uv[..., 1], 0.0, 1.0) * (h - 1)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, h - 2)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    c00 = texture[y0, x0]
    c01 = texture[y0, x0 + 1]
    c10 = texture[y0 + 1, x0]
    c11 = texture[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * c00 + fx * c01)
            + fy * ((1 - fx) * c10 + fx * c11))
