"""Multi-device sharding tests on the virtual 8-CPU mesh (SURVEY §2.6:
the distributed path runs under xla_force_host_platform_device_count
without accelerators — our 'fake backend')."""

import dataclasses as dc

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from computational_ray_tracer_tpu.models.scene import Scene
from computational_ray_tracer_tpu.models import integrator as integ
from computational_ray_tracer_tpu.ops import camera as cam
from computational_ray_tracer_tpu.parallel import sharding as par


def scene_and_camera(res=16):
    scene = Scene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.7, 0.4, 0.3)}],
        lights=[{"kind": "point", "position": (2, 3, -2),
                 "spd_named": "stdillum-D65", "scale": 15.0}],
        spheres=[{"radius": 1.0, "material": 0}])
    camera = cam.PerspectiveCamera.create((0, 0, -4), (res, res), fov_y=40.0,
                                          look_at=(0, 0, 0))
    return scene, camera


def cfg(res=16, spp=4):
    return integ.RenderConfig(
        resolution=(res, res),
        sampler=integ.SamplerConfig(kind="sobol", spp=spp),
        integrator="direct")


def test_mesh_construction():
    m = par.make_mesh(n_dp=4, n_sp=2, devices=jax.devices("cpu"))
    assert dict(m.shape) == {"dp": 4, "sp": 2}
    with pytest.raises(ValueError, match="devices"):
        par.make_mesh(n_dp=4, n_sp=2, devices=jax.devices("cpu")[:3])


@pytest.mark.parametrize("integrator", ["direct", "walk", "simple", "path"])
def test_sharded_matches_single_device_all_integrators(integrator):
    """EVERY integrator must dispatch identically in _pass_for_pixels and
    render_pass."""
    scene, camera = scene_and_camera(16)
    c = dc.replace(cfg(16, 2), integrator=integrator, max_depth=3)
    film_ref, _ = integ.render(scene, camera, c)
    mesh = par.make_mesh(n_dp=4, n_sp=2, devices=jax.devices("cpu"))
    film_sh, _ = par.render_distributed(scene, camera, c, mesh)
    np.testing.assert_allclose(np.asarray(film_sh.rgb_sum),
                               np.asarray(film_ref.rgb_sum),
                               rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("n_dp,n_sp", [(8, 1), (4, 2), (2, 4), (1, 1)])
def test_sharded_matches_single_device(n_dp, n_sp):
    # Placement-invariant determinism: any mesh layout gives the same image
    # (SURVEY §2.6 determinism row).
    scene, camera = scene_and_camera(16)
    c = cfg(16, 4)
    film_ref, sensor = integ.render(scene, camera, c)
    mesh = par.make_mesh(n_dp=n_dp, n_sp=n_sp, devices=jax.devices("cpu"))
    film_sh, _ = par.render_distributed(scene, camera, c, mesh)
    np.testing.assert_allclose(np.asarray(film_sh.rgb_sum),
                               np.asarray(film_ref.rgb_sum), atol=2e-6)
    np.testing.assert_allclose(np.asarray(film_sh.weight_sum),
                               np.asarray(film_ref.weight_sum), atol=2e-6)
    assert int(film_sh.spp_done) == 4


def test_sharded_train_step_runs_and_reduces():
    scene, camera = scene_and_camera(8)
    c = dc.replace(cfg(8, 2), integrator="path", max_depth=2)
    mesh = par.make_mesh(n_dp=4, n_sp=2, devices=jax.devices("cpu"))

    def extract(s):
        return {"albedo": s.materials.albedo_coeffs}

    def insert(s, p):
        return dc.replace(s, materials=dc.replace(
            s.materials, albedo_coeffs=p["albedo"]))

    train_step, opt_init, _ = par.make_train_step(scene, camera, c, mesh,
                                                  (extract, insert))
    params = extract(scene)
    opt_state = opt_init(params)
    target = jnp.zeros((8, 8, 3))
    p0 = np.asarray(params["albedo"]).copy()
    losses = []
    for i in range(8):
        params, opt_state, loss = train_step(params, opt_state, scene,
                                             target, i * 2)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert not np.allclose(np.asarray(params["albedo"]), p0)  # moved
    # driving toward a black target darkens: average loss should trend down
    assert np.mean(losses[-3:]) <= np.mean(losses[:3])


def test_sharded_gradients_match_unsharded():
    scene, camera = scene_and_camera(8)
    c = dc.replace(cfg(8, 2), integrator="direct")
    mesh = par.make_mesh(n_dp=4, n_sp=2, devices=jax.devices("cpu"))
    from computational_ray_tracer_tpu.models import inverse as inv

    extract, insert = inv.albedo_params(scene)
    target = jnp.full((8, 8, 3), 0.1)

    # unsharded reference grad over the same 2 sample passes
    render_image, _ = inv.make_render_fn(camera, c)

    def loss_unsh(params):
        return jnp.mean((render_image(insert(scene, params)) - target) ** 2)

    g_ref = jax.grad(loss_unsh)(extract(scene))

    train_step, opt_init, _ = par.make_train_step(
        scene, camera, c, mesh, (extract, insert))
    # extract grads by using SGD with lr so update = -lr*g... simpler: call
    # the internal sharded grad via one step with zero-momentum SGD
    import optax
    train_step2, opt_init2, _ = par.make_train_step(
        scene, camera, c, mesh, (extract, insert),
        optimizer=optax.sgd(1.0))
    params = extract(scene)
    p_new, _, loss = train_step2(params, opt_init2(params), scene, target, 0)
    g_sh = jax.tree_util.tree_map(lambda a, b: a - b, params, p_new)
    np.testing.assert_allclose(np.asarray(g_sh["albedo_coeffs"]),
                               np.asarray(g_ref["albedo_coeffs"]),
                               rtol=1e-3, atol=1e-7)


def test_global_mesh_and_init():
    from computational_ray_tracer_tpu.parallel import sharding as par
    n_proc, n_dev = par.init_distributed()     # single-process no-op
    assert n_proc == 1 and n_dev >= 8
    m = par.global_mesh(n_sp=2)
    assert dict(m.shape)["sp"] == 2
    assert dict(m.shape)["dp"] * 2 == n_dev


def test_sharded_packed_octree_matches_single_device():
    """The flagship mesh path under shard_map: an octree scene must
    replicate correctly and render identically to the single-device image
    through the traversal op (the jnp branch on CPU devices)."""
    from __graft_entry__ import _cornell_setup

    scene, camera, _ = _cornell_setup(res=16, spp=2, use_octree=True)
    c = integ.RenderConfig(
        resolution=(16, 16),
        sampler=integ.SamplerConfig(kind="sobol", spp=2),
        integrator="path", max_depth=3)
    film_ref, _ = integ.render(scene, camera, c)
    mesh = par.make_mesh(n_dp=4, n_sp=2, devices=jax.devices("cpu"))
    film_sh, _ = par.render_distributed(scene, camera, c, mesh)
    np.testing.assert_allclose(np.asarray(film_sh.rgb_sum),
                               np.asarray(film_ref.rgb_sum),
                               rtol=1e-4, atol=1e-5)
