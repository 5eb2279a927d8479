"""The octree traversal op (ops/traversal.py): the jnp traversal against
brute force, the op's zero-tangent rule, which lowering each platform gets,
and (marked ``gpu``) the CUDA kernel against the jnp traversal on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from computational_ray_tracer_tpu.ops import octree as octmod
from computational_ray_tracer_tpu.ops import traversal
from computational_ray_tracer_tpu.ops import triangle as trimod
from computational_ray_tracer_tpu.utils import mesh_gen


def _icosphere():
    v, f, uv = mesh_gen.displaced_icosphere(2)
    return trimod.MeshData.build(v, f, uvs=uv)


def _cornell():
    pos, idx, uv, _, _ = mesh_gen.cornell_box(2.0)
    return trimod.MeshData.build(pos, idx, uvs=uv)


def _soup():
    # overlapping random triangles: many leaves hold shared triangles
    rng = np.random.default_rng(3)
    c = rng.uniform(-1.0, 1.0, (150, 1, 3))
    v = (c + rng.normal(0.0, 0.25, (150, 3, 3))).reshape(-1, 3)
    return trimod.MeshData.build(v, np.arange(450).reshape(150, 3))


MESHES = {"icosphere": _icosphere, "cornell": _cornell, "soup": _soup}


@pytest.fixture(scope="module")
def meshes():
    return {k: fn() for k, fn in MESHES.items()}


def _rays(n=256, seed=0):
    """Rays from a shell around the unit box toward random interior points
    (hits, grazing rays and misses)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    tgt = rng.uniform(-1.2, 1.2, (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def _t_max(kind, n, seed=1):
    if kind == "finite":
        rng = np.random.default_rng(seed)
        return jnp.asarray(rng.uniform(1.0, 4.0, n), jnp.float32)
    return jnp.full((n,), jnp.inf)


def _setup(meshes, name, cap, variant):
    mesh = meshes[name]
    tree = octmod.build_octree(mesh, capacity=cap)
    o, d = _rays()
    t_max = _t_max(variant, o.shape[0])
    mask = (trimod.compute_backface_mask(mesh, (0.3, 0.2, 1.0))
            if variant == "mask" else None)
    return mesh, tree, o, d, t_max, mask


@pytest.mark.parametrize("variant", ["inf", "finite", "mask"])
@pytest.mark.parametrize("cap", [4, 16, 64])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_octree_traverse_matches_brute(meshes, name, cap, variant):
    mesh, tree, o, d, t_max, mask = _setup(meshes, name, cap, variant)
    t, tri, b1, b2, tests = octmod.octree_traverse(o, d, t_max, tree, mesh,
                                                   mask)
    tb, jb, b1b, b2b, _ = trimod.mesh_intersect_brute(o, d, t_max, mesh,
                                                      mask)
    hit_b = np.isfinite(np.asarray(tb))
    hit = np.asarray(tri) >= 0
    np.testing.assert_array_equal(hit, hit_b)
    np.testing.assert_array_equal(np.isfinite(np.asarray(t)), hit)
    assert hit.any() and not hit.all()
    # the brute-force layout rounds the permuted coordinates differently:
    # a few float32 ulps on t and the barycentrics
    np.testing.assert_allclose(np.asarray(t)[hit], np.asarray(tb)[hit],
                               rtol=1e-5)
    # ids may differ only at exact ties (shared edges and vertices)
    same = np.asarray(tri)[hit] == np.asarray(jb)[hit]
    assert same.mean() >= 0.99
    np.testing.assert_allclose(np.asarray(b1)[hit][same],
                               np.asarray(b1b)[hit][same], atol=1e-5)
    np.testing.assert_allclose(np.asarray(b2)[hit][same],
                               np.asarray(b2b)[hit][same], atol=1e-5)
    assert (np.asarray(tests)[hit] > 0).all()
    assert np.asarray(tests).max() < mesh.n_triangles * 8


@pytest.mark.parametrize("cap", [4, 64])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_any_hit_matches_brute(meshes, name, cap):
    mesh, tree, o, d, _, _ = _setup(meshes, name, cap, "finite")
    t_max = _t_max("finite", o.shape[0], seed=7) * 0.5
    # dead (t_max <= 0) rays never hit
    t_max = t_max.at[:16].set(-1.0)
    got = traversal.any_hit(o, d, t_max, tree, mesh)
    want = trimod.mesh_anyhit_brute(o, d, t_max, mesh)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert not np.asarray(got)[:16].any()


def test_closest_hit_is_octree_traverse_off_gpu(meshes):
    mesh, tree, o, d, t_max, _ = _setup(meshes, "icosphere", 16, "inf")
    got = jax.jit(traversal.closest_hit)(o, d, t_max, tree, mesh)
    want = octmod.octree_traverse(o, d, t_max, tree, mesh)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_traversal_jvp_is_zero(meshes):
    """Hit ids and distances are sampling decisions: zero tangents with
    respect to the rays, forward and reverse."""
    mesh, tree, o, d, t_max, _ = _setup(meshes, "icosphere", 16, "inf")

    def f(o, d):
        t, _, b1, b2, _ = traversal.closest_hit(o, d, t_max, tree, mesh)
        return jnp.where(jnp.isfinite(t), t, 0.0) + b1 + b2

    _, tan = jax.jvp(f, (o, d), (jnp.ones_like(o), jnp.ones_like(d)))
    assert float(jnp.abs(tan).max()) == 0.0
    go, gd = jax.grad(lambda o, d: jnp.sum(f(o, d)), argnums=(0, 1))(o, d)
    assert float(jnp.abs(go).max()) == 0.0 and float(jnp.abs(gd).max()) == 0


def _direct_mesh_pass():
    from computational_ray_tracer_tpu.models import integrator as integ
    from computational_ray_tracer_tpu.models.scene import Scene
    from computational_ray_tracer_tpu.ops import camera as cam

    mesh = _icosphere()
    scene = Scene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.7, 0.6, 0.5)}],
        lights=[{"kind": "distant", "direction": (-0.4, -1.0, 0.5),
                 "rgb": (1, 1, 1), "scale": 4.0}],
        mesh=(mesh, jnp.zeros((mesh.n_triangles,), jnp.int32)),
        use_octree=True, octree_capacity=16)
    camera = cam.PerspectiveCamera.create((0, 0.5, -3.4), (8, 8),
                                          fov_y=40.0, look_at=(0, 0, 0))
    cfg = integ.RenderConfig(resolution=(8, 8),
                             sampler=integ.SamplerConfig(spp=1),
                             integrator="direct", max_depth=1)
    filter_obj = integ.make_filter(cfg)
    sensor = integ.make_sensor(cfg)

    def one_pass(scene, sample_idx):
        return integ.render_pass(scene, camera, cfg, filter_obj, sensor,
                                 sample_idx)
    return one_pass, scene


@pytest.mark.parametrize("platform,has_call", [("cuda", True),
                                               ("cpu", False)])
def test_render_pass_lowering_per_platform(platform, has_call):
    """The same jitted pass lowers to the CUDA custom call (closest hit and
    shadow any-hit) for a GPU and to the jnp loop for the CPU."""
    one_pass, scene = _direct_mesh_pass()
    text = jax.jit(one_pass).trace(scene, jnp.uint32(0)).lower(
        lowering_platforms=(platform,)).as_text()
    assert (text.count(traversal.FFI_TARGET) >= 2) == has_call
    assert (traversal.FFI_TARGET in text) == has_call
    assert ("while" in text) != has_call


def test_anyhit_flag_reaches_the_kernel():
    mesh = _icosphere()
    tree = octmod.build_octree(mesh, capacity=16)
    o, d = _rays(8)
    t = jnp.full((8,), jnp.inf)
    for fn, flag in ((traversal.closest_hit, 0), (traversal.any_hit, 1)):
        text = jax.jit(lambda o, d, t: fn(o, d, t, tree, mesh)).trace(
            o, d, t).lower(lowering_platforms=("cuda",)).as_text()
        assert f"anyhit = {flag} : i32" in text


def test_tree_depth_and_stack_bound():
    # root -> 8 children, child 3 -> 8 grandchildren
    child0 = np.full(17, -1, np.int32)
    child0[0] = 1
    child0[4] = 9
    assert octmod.tree_depth(child0) == 2
    assert octmod.tree_depth(np.array([-1], np.int32)) == 0
    mesh = _icosphere()
    tree = octmod.build_octree(mesh, capacity=4)
    assert 7 * octmod.tree_depth(tree.node_child0) + 1 <= octmod.STACK_SIZE


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against the jnp traversal
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["inf", "finite", "mask"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_cuda_kernel_matches_jnp(gpu_device, meshes, name, variant):
    mesh, tree, o, d, t_max, mask = _setup(meshes, name, 16, variant)
    args = jax.device_put((o, d, t_max, tree, mesh, mask), gpu_device)
    got = jax.jit(traversal.closest_hit)(*args)
    want = octmod.octree_traverse(o, d, t_max, tree, mesh, mask)
    ids_g, ids_w = np.asarray(got[1]), np.asarray(want[1])
    assert (ids_g == ids_w).mean() >= 0.99
    same = (ids_g == ids_w) & (ids_w >= 0)
    np.testing.assert_allclose(np.asarray(got[0])[same],
                               np.asarray(want[0])[same], rtol=1e-5)
    np.testing.assert_array_equal(np.isinf(np.asarray(got[0])), ids_g < 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MESHES))
def test_cuda_any_hit_matches_jnp(gpu_device, meshes, name):
    mesh, tree, o, d, t_max, _ = _setup(meshes, name, 16, "finite")
    t_max = t_max.at[:16].set(-1.0)
    args = jax.device_put((o, d, t_max, tree, mesh), gpu_device)
    got = jax.jit(traversal.any_hit)(*args)
    want = trimod.mesh_anyhit_brute(o, d, t_max, mesh)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.gpu
def test_cuda_render_pass_calls_kernel(gpu_device):
    one_pass, scene = _direct_mesh_pass()
    scene = jax.device_put(scene, gpu_device)
    compiled = jax.jit(one_pass).lower(scene, jnp.uint32(0)).compile()
    assert traversal.FFI_TARGET in compiled.as_text()
    rgb, wt = compiled(scene, jnp.uint32(0))
    ref_rgb, _ = jax.jit(one_pass)(jax.device_put(scene, jax.devices(
        "cpu")[0]), jnp.uint32(0))
    np.testing.assert_allclose(np.asarray(rgb), np.asarray(ref_rgb),
                               atol=1e-4)

