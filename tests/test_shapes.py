"""Geometry core tests (capability: ShapeTestApp visual checks become
asserted math; octree-vs-brute-force is the reference's kd_enable
side-by-side, SURVEY §4)."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from computational_ray_tracer_tpu.ops import shapes as shp
from computational_ray_tracer_tpu.ops import triangle as trimod
from computational_ray_tracer_tpu.ops import octree as octmod
from computational_ray_tracer_tpu.utils import mesh_gen


def _rays(o_list, d_list):
    o = jnp.asarray(o_list, jnp.float32)
    d = jnp.asarray(d_list, jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, jnp.full(o.shape[:-1], jnp.inf)


def test_sphere_basic_hit():
    tab = shp.SphereTable.build([{"radius": 1.0}])
    o, d, tm = _rays([[0, 0, -4]], [[0, 0, 1]])
    t = shp.sphere_intersect_t(o, d, tm, tab)
    assert t.shape == (1, 1)
    assert float(t[0, 0]) == pytest.approx(3.0, abs=1e-4)
    si = shp.sphere_surface(o, d, t[:, 0], jnp.zeros(1, jnp.int32), tab)
    np.testing.assert_allclose(np.asarray(si.p[0]), [0, 0, -1], atol=1e-4)
    np.testing.assert_allclose(np.asarray(si.n[0]), [0, 0, -1], atol=1e-4)


def test_sphere_miss_and_inside():
    tab = shp.SphereTable.build([{"radius": 1.0}])
    o, d, tm = _rays([[0, 2, -4], [0, 0, 0]], [[0, 0, 1], [0, 0, 1]])
    t = shp.sphere_intersect_t(o, d, tm, tab)
    assert not np.isfinite(float(t[0, 0]))        # miss above
    assert float(t[1, 0]) == pytest.approx(1.0, abs=1e-4)  # inside: exit hit


def test_sphere_clipping():
    # clip to upper half (z >= 0): equator-grazing ray from below misses
    tab = shp.SphereTable.build([{"radius": 1.0, "z_min": 0.0}])
    o, d, tm = _rays([[0, 0, -4], [-4, 0, 0.5]], [[0, 0, 1], [1, 0, 0]])
    t = shp.sphere_intersect_t(o, d, tm, tab)
    # ray through center: front hit at z=-1 is clipped; back half z>0...
    # entry point (0,0,-1) has z<0 -> clipped; exit (0,0,1) valid: t=5
    assert float(t[0, 0]) == pytest.approx(5.0, abs=1e-3)
    # ray at z=0.5 hits the clipped sphere
    assert np.isfinite(float(t[1, 0]))


def test_sphere_phi_clip():
    tab = shp.SphereTable.build([{"radius": 1.0, "phi_max": math.pi}])
    # phi in [0, pi] keeps +y side; ray toward -y side should pass through
    o, d, tm = _rays([[0, -4, 0]], [[0, 1, 0]])
    t = shp.sphere_intersect_t(o, d, tm, tab)
    # entry at (0,-1,0): phi = 3pi/2 > pi -> clipped; exit (0,1,0) phi=pi/2 ok
    assert float(t[0, 0]) == pytest.approx(5.0, abs=1e-3)


def test_sphere_transform():
    tr = shp.make_transform(translate=(2.0, 0.0, 0.0), scale=2.0)
    tab = shp.SphereTable.build([{"radius": 1.0, "transform": tr}])
    o, d, tm = _rays([[2, 0, -10]], [[0, 0, 1]])
    t = shp.sphere_intersect_t(o, d, tm, tab)
    assert float(t[0, 0]) == pytest.approx(8.0, abs=1e-3)  # radius 2 at x=2


def test_sphere_uv():
    tab = shp.SphereTable.build([{"radius": 1.0}])
    o, d, tm = _rays([[2, 0, 0]], [[-1, 0, 0]])
    t = shp.sphere_intersect_t(o, d, tm, tab)
    si = shp.sphere_surface(o, d, t[:, 0], jnp.zeros(1, jnp.int32), tab)
    # hit at (1,0,0): phi=0 -> u=0; theta=pi/2 -> v=0.5
    assert float(si.uv[0, 0]) == pytest.approx(0.0, abs=1e-3)
    assert float(si.uv[0, 1]) == pytest.approx(0.5, abs=1e-3)


def test_cylinder_hit_and_normal():
    tab = shp.CylinderTable.build([{"radius": 1.0, "z_min": -1, "z_max": 1}])
    o, d, tm = _rays([[-4, 0, 0.3]], [[1, 0, 0]])
    t = shp.cylinder_intersect_t(o, d, tm, tab)
    assert float(t[0, 0]) == pytest.approx(3.0, abs=1e-4)
    si = shp.cylinder_surface(o, d, t[:, 0], jnp.zeros(1, jnp.int32), tab)
    np.testing.assert_allclose(np.asarray(si.n[0]), [-1, 0, 0], atol=1e-4)
    # z clip
    o2, d2, tm2 = _rays([[-4, 0, 1.5]], [[1, 0, 0]])
    t2 = shp.cylinder_intersect_t(o2, d2, tm2, tab)
    assert not np.isfinite(float(t2[0, 0]))


def test_disk_hit():
    tab = shp.DiskTable.build([{"radius": 1.0, "inner_radius": 0.25,
                                "height": 0.0}])
    o, d, tm = _rays([[0.5, 0, -3], [0.1, 0, -3], [1.5, 0, -3]],
                     [[0, 0, 1]] * 3)
    t = shp.disk_intersect_t(o, d, tm, tab)
    assert float(t[0, 0]) == pytest.approx(3.0, abs=1e-4)
    assert not np.isfinite(float(t[1, 0]))  # inside inner radius
    assert not np.isfinite(float(t[2, 0]))  # outside outer radius


def test_triangle_watertight_basic():
    p0 = jnp.asarray([[-1.0, -1.0, 0.0]])
    p1 = jnp.asarray([[1.0, -1.0, 0.0]])
    p2 = jnp.asarray([[0.0, 1.0, 0.0]])
    o = jnp.asarray([[0.0, -0.2, -5.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    t, b0, b1, b2, hit = trimod.triangle_intersect(
        o, d, jnp.asarray([jnp.inf]), p0, p1, p2)
    assert bool(hit[0])
    assert float(t[0]) == pytest.approx(5.0, abs=1e-4)
    assert float(b0[0] + b1[0] + b2[0]) == pytest.approx(1.0, abs=1e-5)
    # barycentric reconstruction matches the hit point
    hp = b0[0] * p0[0] + b1[0] * p1[0] + b2[0] * p2[0]
    np.testing.assert_allclose(np.asarray(hp), [0.0, -0.2, 0.0], atol=1e-5)


def test_triangle_watertight_shared_edge_no_leak():
    # A ray aimed exactly at the shared edge of two triangles must hit at
    # least one of them (the watertight guarantee, Shapes.h:1169-1184).
    quad_p, quad_i, _ = mesh_gen.quad((-1, -1, 0), (2, 0, 0), (0, 2, 0))
    p = jnp.asarray(quad_p)
    i = jnp.asarray(quad_i)
    # shared edge runs from (-1,-1,0) to (1,1,0); aim along it
    targets = np.stack([np.linspace(-0.99, 0.99, 101),
                        np.linspace(-0.99, 0.99, 101),
                        np.zeros(101)], axis=1)
    o = jnp.asarray(np.concatenate([targets[:, :2],
                                    np.full((101, 1), -7.0)], axis=1),
                    jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]] * 101, jnp.float32)
    hits = 0
    for tri in range(2):
        t, _, _, _, h = trimod.triangle_intersect(
            o, d, jnp.full((101,), jnp.inf),
            p[i[tri, 0]], p[i[tri, 1]], p[i[tri, 2]])
        hits = hits + np.asarray(h).astype(int)
    assert (hits >= 1).all()


def test_simple_triangle_matches_watertight():
    key = jax.random.PRNGKey(0)
    p0 = jax.random.normal(key, (64, 3))
    p1 = p0 + jax.random.normal(jax.random.PRNGKey(1), (64, 3))
    p2 = p0 + jax.random.normal(jax.random.PRNGKey(2), (64, 3))
    o = jnp.asarray([[0.0, 0.0, -5.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    tw, _, _, _, hw = trimod.triangle_intersect(
        o, d, jnp.asarray([jnp.inf]), p0, p1, p2)
    ts, _, _, _, hs = trimod.simple_triangle_intersect(
        o, d, jnp.asarray([jnp.inf]), p0, p1, p2)
    agree = np.asarray(hw) == np.asarray(hs)
    assert agree.mean() > 0.97  # disagreement only at degenerate edges
    both = np.asarray(hw) & np.asarray(hs)
    np.testing.assert_allclose(np.asarray(tw)[both], np.asarray(ts)[both],
                               rtol=1e-3)


def test_mesh_brute_force_closest():
    pos, idx, uv = mesh_gen.box((-1, -1, -1), (1, 1, 1))
    mesh = trimod.MeshData.build(pos, idx, uvs=uv)
    o = jnp.asarray([[0.0, 0.0, -5.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    t, ti, b1, b2, cnt = trimod.mesh_intersect_brute(
        o, d, jnp.asarray([jnp.inf]), mesh)
    assert float(t[0]) == pytest.approx(4.0, abs=1e-4)  # front face at z=-1
    assert int(cnt[0]) == mesh.n_triangles


def test_mesh_chunked_matches_unchunked():
    pos, idx, uv = mesh_gen.uv_sphere((0, 0, 0), 1.0, 8, 12)
    mesh = trimod.MeshData.build(pos, idx, uvs=uv)
    key = jax.random.PRNGKey(3)
    o = jax.random.normal(key, (32, 3)) * 3.0
    d = -o / jnp.linalg.norm(o, axis=-1, keepdims=True)
    tm = jnp.full((32,), jnp.inf)
    t1, i1, _, _, _ = trimod.mesh_intersect_brute(o, d, tm, mesh)
    t2, i2, _, _, _ = trimod.mesh_intersect_brute(o, d, tm, mesh, chunk=37)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=1e-5)


def test_octree_matches_brute_force():
    pos, idx, uv = mesh_gen.uv_sphere((0, 0, 0), 1.0, 12, 18)
    mesh = trimod.MeshData.build(pos, idx, uvs=uv)
    tree = octmod.build_octree(mesh, capacity=16)
    info = tree.info()
    assert info["nodes"] > 1
    assert info["max_tris_per_leaf"] > 0
    key = jax.random.PRNGKey(5)
    o = jax.random.normal(key, (128, 3)) * 3.0
    # aim roughly at the sphere with jitter
    target = jax.random.normal(jax.random.PRNGKey(6), (128, 3)) * 0.5
    d = target - o
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    tm = jnp.full((128,), jnp.inf)
    tb, ib, _, _, _ = trimod.mesh_intersect_brute(o, d, tm, mesh)
    to, io, _, _, tests = octmod.octree_traverse(o, d, tm, tree, mesh)
    np.testing.assert_allclose(np.asarray(tb), np.asarray(to), rtol=1e-4,
                               atol=1e-5)
    hit = np.isfinite(np.asarray(tb))
    np.testing.assert_array_equal(np.asarray(ib)[hit], np.asarray(io)[hit])
    # traversal should test far fewer triangles than brute force
    assert float(np.asarray(tests)[hit].mean()) < mesh.n_triangles * 0.6


def test_backface_cull_mask():
    pos, idx, uv = mesh_gen.box((-1, -1, -1), (1, 1, 1))
    mesh = trimod.MeshData.build(pos, idx, uvs=uv)
    keep = trimod.compute_backface_mask(mesh, (0.0, 0.0, 1.0))
    # looking along +z: front (-z) faces kept, back (+z) culled
    assert 0 < int(keep.sum()) < mesh.n_triangles


def test_bounds_intersect():
    lo = jnp.asarray([-1.0, -1.0, -1.0])
    hi = jnp.asarray([1.0, 1.0, 1.0])
    o = jnp.asarray([[0, 0, -5], [0, 3, -5], [0, 0, 5]], jnp.float32)
    d = jnp.asarray([[0, 0, 1], [0, 0, 1], [0, 0, 1]], jnp.float32)
    inv_d = 1.0 / d
    hit = shp.bounds_intersect_p(o, inv_d, jnp.full((3,), jnp.inf), lo, hi)
    assert bool(hit[0])
    assert not bool(hit[1])
    assert not bool(hit[2])  # box behind ray


def test_transform_bounds_contains_transformed_points():
    m, mi = shp.make_transform(translate=(1, 2, 3), rotate_deg=(30, 45, 10),
                               scale=1.5)
    lo = jnp.asarray([-1.0, -2.0, -0.5])
    hi = jnp.asarray([1.0, 0.5, 2.0])
    nlo, nhi = shp.transform_bounds(jnp.asarray(m), lo, hi)
    # every transformed corner is inside the new bounds
    rng = np.random.default_rng(0)
    pts = rng.uniform(np.asarray(lo), np.asarray(hi), (100, 3)).astype(np.float32)
    tp = np.asarray(shp.transform_point(jnp.asarray(m), jnp.asarray(pts)))
    assert (tp >= np.asarray(nlo) - 1e-4).all()
    assert (tp <= np.asarray(nhi) + 1e-4).all()


def test_stable_quadratic():
    # catastrophic-cancellation case: b >> a, c
    t0, t1, has = shp.stable_quadratic(jnp.float32(1.0), jnp.float32(1e4),
                                       jnp.float32(1.0))
    assert bool(has)
    # roots: ~ -1e-4 and ~ -1e4 (product = c/a = 1)
    assert float(t0 * t1) == pytest.approx(1.0, rel=1e-3)
    assert float(t0) == pytest.approx(-1e4, rel=1e-3)
    assert float(t1) == pytest.approx(-1e-4, rel=1e-3)


def test_mesh_surface_matches_numpy():
    """Barycentric attribute interpolation (gather + lerp) against a NumPy
    reference, including the flip toward the viewer and the tri_idx = -1
    placeholder rows."""
    v, f, uv = mesh_gen.displaced_icosphere(1)
    mesh = trimod.MeshData.build(v, f, uvs=uv)
    rng = np.random.default_rng(5)
    n = 32
    tri = rng.integers(0, mesh.n_triangles, n).astype(np.int32)
    tri[:3] = -1
    b1 = rng.uniform(0.0, 0.5, n).astype(np.float32)
    b2 = rng.uniform(0.0, 0.5, n).astype(np.float32)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 3.0
    d = -o / np.linalg.norm(o, axis=1, keepdims=True)
    t = np.where(tri >= 0, 1.0, np.inf).astype(np.float32)
    si = trimod.mesh_surface(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                             jnp.asarray(tri), jnp.asarray(b1),
                             jnp.asarray(b2), mesh)

    idx = np.asarray(mesh.indices)[np.maximum(tri, 0)]
    w = np.stack([1.0 - b1 - b2, b1, b2], 1)[..., None]

    def lerp(attr):
        return np.sum(w * np.asarray(attr)[idx], axis=1)

    np.testing.assert_allclose(np.asarray(si.p), lerp(mesh.positions),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(si.uv), lerp(mesh.uvs), atol=1e-5)
    np.testing.assert_allclose(np.asarray(si.dpdu), lerp(mesh.tangents),
                               atol=1e-5)
    nrm = lerp(mesh.normals)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    wo = -d
    nrm = np.where(np.sum(nrm * wo, 1, keepdims=True) < 0, -nrm, nrm)
    np.testing.assert_allclose(np.asarray(si.n), nrm, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(si.valid), tri >= 0)
