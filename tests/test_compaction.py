"""Wavefront compaction must change no rendered value (SURVEY §7 stance
#1: alive-mask + compaction; the determinism contract says every sample is
a pure function of (seed, pixel, sample, dim), so ray-set membership and
order are invisible in the image)."""

import numpy as np
import jax.numpy as jnp
import pytest

from computational_ray_tracer_tpu.models import integrator as integ
from __graft_entry__ import _cornell_setup


@pytest.mark.parametrize("mode", ["path", "simple"])
def test_compact_matches_full(mode):
    scene, camera, _ = _cornell_setup(res=32, spp=4)
    cfg = integ.RenderConfig(
        resolution=(32, 32),
        sampler=integ.SamplerConfig(kind="sobol", spp=4),
        integrator=mode, max_depth=6, compact=True, compact_quantum=128)
    filter_obj = integ.make_filter(cfg)
    sensor = integ.make_sensor(cfg)

    rgb_f, wt_f = integ.render_pass(scene, camera, cfg, filter_obj, sensor,
                                    jnp.uint32(1))
    rgb_c, wt_c = integ.render_pass_compact(scene, camera, cfg, filter_obj,
                                            sensor, jnp.uint32(1))
    # tolerances absorb cross-program fusion rounding (~1e-7), nothing more
    np.testing.assert_allclose(np.asarray(wt_c), np.asarray(wt_f),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(rgb_c), np.asarray(rgb_f),
                               rtol=1e-4, atol=1e-5)


def test_render_honors_compact_flag():
    """The PUBLIC driver must route through compaction when cfg.compact is
    set — and produce the identical film."""
    scene, camera, _ = _cornell_setup(res=32, spp=2)
    base = integ.RenderConfig(
        resolution=(32, 32),
        sampler=integ.SamplerConfig(kind="sobol", spp=2),
        integrator="path", max_depth=5)
    import dataclasses as dc
    film_full, _ = integ.render(scene, camera, base)
    film_cmp, _ = integ.render(scene, camera,
                               dc.replace(base, compact=True,
                                          compact_quantum=128))
    assert int(film_cmp.spp_done) == 2
    np.testing.assert_allclose(np.asarray(film_cmp.rgb_sum),
                               np.asarray(film_full.rgb_sum),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(film_cmp.weight_sum),
                               np.asarray(film_full.weight_sum),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", ["path", "direct"])
def test_spectral_cache_guard_matches_uncached(mode):
    """Scenes past the cache column budget fall back to per-site
    interpolation (unbounded where-chain); the fallback
    must render identical values. Force the guard off via the threshold."""
    scene, camera, _ = _cornell_setup(res=16, spp=2)
    assert integ._use_spectral_cache(scene)
    cfg = integ.RenderConfig(
        resolution=(16, 16),
        sampler=integ.SamplerConfig(kind="sobol", spp=2),
        integrator=mode, max_depth=3)
    filter_obj = integ.make_filter(cfg)
    sensor = integ.make_sensor(cfg)
    rgb_c, wt_c = integ.render_pass(scene, camera, cfg, filter_obj, sensor,
                                    jnp.uint32(0))
    old = integ.SPECTRAL_CACHE_MAX_COLS
    try:
        integ.SPECTRAL_CACHE_MAX_COLS = 0
        assert not integ._use_spectral_cache(scene)
        rgb_u, wt_u = integ.render_pass(scene, camera, cfg, filter_obj,
                                        sensor, jnp.uint32(0))
    finally:
        integ.SPECTRAL_CACHE_MAX_COLS = old
    np.testing.assert_allclose(np.asarray(rgb_u), np.asarray(rgb_c),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(wt_u), np.asarray(wt_c),
                               rtol=1e-6, atol=1e-7)


def test_compact_mesh_octree_scene():
    """Compaction through the packet-octree mesh path (buckets are padded
    to packet tiles inside the kernel wrapper)."""
    from computational_ray_tracer_tpu.models.scene import Scene
    from computational_ray_tracer_tpu.ops import camera as cam
    from computational_ray_tracer_tpu.ops import triangle as trimod
    from computational_ray_tracer_tpu.utils import mesh_gen

    v, f, uv = mesh_gen.displaced_icosphere(2)
    mesh = trimod.MeshData.build(v, f, uvs=uv)
    scene = Scene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.7, 0.6, 0.5)}],
        lights=[{"kind": "distant", "direction": (-0.4, -1.0, 0.5),
                 "rgb": (1, 1, 1), "scale": 4.0},
                {"kind": "ambient", "spd_named": "stdillum-D65",
                 "scale": 0.2}],
        mesh=(mesh, jnp.zeros((mesh.n_triangles,), jnp.int32)),
        use_octree=True)
    camera = cam.PerspectiveCamera.create((0, 0.5, -3.4), (16, 16),
                                          fov_y=40.0, look_at=(0, 0, 0))
    cfg = integ.RenderConfig(
        resolution=(16, 16),
        sampler=integ.SamplerConfig(kind="independent", spp=2),
        integrator="path", max_depth=4, compact=True, compact_quantum=64)
    filter_obj = integ.make_filter(cfg)
    sensor = integ.make_sensor(cfg)
    rgb_f, _ = integ.render_pass(scene, camera, cfg, filter_obj, sensor,
                                 jnp.uint32(0))
    rgb_c, _ = integ.render_pass_compact(scene, camera, cfg, filter_obj,
                                         sensor, jnp.uint32(0))
    np.testing.assert_allclose(np.asarray(rgb_c), np.asarray(rgb_f),
                               rtol=1e-4, atol=1e-5)


def test_compact_predicted_schedule_matches_exact():
    """Pass 2+ uses the predicted-bucket path (schedule recorded by pass
    1, single end-of-pass overflow check); every pass must still equal the
    full-wavefront render bit-for-bit-close."""
    scene, camera, _ = _cornell_setup(res=32, spp=4)
    cfg = integ.RenderConfig(
        resolution=(32, 32),
        sampler=integ.SamplerConfig(kind="sobol", spp=4),
        integrator="path", max_depth=6, compact=True, compact_quantum=128)
    filter_obj = integ.make_filter(cfg)
    sensor = integ.make_sensor(cfg)
    integ._BUCKET_SCHEDULE.clear()
    for s in range(3):
        rgb_c, wt_c = integ.render_pass_compact(scene, camera, cfg,
                                                filter_obj, sensor,
                                                jnp.uint32(s))
        rgb_f, wt_f = integ.render_pass(scene, camera, cfg, filter_obj,
                                        sensor, jnp.uint32(s))
        np.testing.assert_allclose(np.asarray(rgb_c), np.asarray(rgb_f),
                                   rtol=1e-4, atol=1e-5, err_msg=f"pass {s}")
    # the schedule must have been recorded by the first (exact) pass
    assert any(len(counts) > 0
               for (_cam, counts) in integ._BUCKET_SCHEDULE.values())


def test_compact_predicted_overflow_redoes_exactly():
    """A poisoned schedule (all-zero counts) must be detected by the
    on-device fit check and redone on the exact path — same image."""
    scene, camera, _ = _cornell_setup(res=16, spp=2)
    cfg = integ.RenderConfig(
        resolution=(16, 16),
        sampler=integ.SamplerConfig(kind="sobol", spp=2),
        integrator="path", max_depth=4, compact=True, compact_quantum=64)
    filter_obj = integ.make_filter(cfg)
    sensor = integ.make_sensor(cfg)
    integ._BUCKET_SCHEDULE.clear()
    rgb_ref, _ = integ.render_pass(scene, camera, cfg, filter_obj, sensor,
                                   jnp.uint32(0))
    # poison: schedule claims the wavefront is dead at depth 0
    mode = "mis"
    key = (cfg, mode, id(camera))
    integ._BUCKET_SCHEDULE[key] = (camera, [0])
    rgb_c, _ = integ.render_pass_compact(scene, camera, cfg, filter_obj,
                                         sensor, jnp.uint32(0))
    np.testing.assert_allclose(np.asarray(rgb_c), np.asarray(rgb_ref),
                               rtol=1e-4, atol=1e-5)
