"""Benchmark harness (BASELINE.md north-star metrics). Prints ONE JSON line:
{"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

Workloads, all on one GPU (the run fails without one):
- headline: rays/sec on the 1024spp Cornell box (path MIS, depth 4,
  Sobol);
- legacy pin: the identical config is ALSO timed with the round-1 launch
  shape (one render_pass per spp, no chunking) so config/driver changes
  can never hide a regression behind a definition change;
- dragon-class mesh (detail.mesh): direct lighting on a 327k-tri displaced
  icosphere through the octree traversal at 512x512;
- flagship parity (detail.flagship): the reference's canonical workload
  end-to-end — textured mesh + octree + path/MIS + gaussian filter +
  sensor resolve at 512x512 (RayTracerTestApp.h:70-189);
- 872k-tri x15-scale irregular mesh (detail.mesh870) with leaf-table and
  device-memory accounting;
- the reference's CANONICAL workload (detail.canonical): 500x500,
  stratified 10x10 spp, 872k tris at the reference's leaf cap 40,
  thin-lens camera, triangle filter, no-shadow Li — committed PNG +
  CPU-golden gate (benchmarks/canonical.py);
- 512^2 depth-8 through the public render() (detail.deep512, compacted);
- golden gate (detail.golden_gate): the 128x128 Cornell golden config
  rendered on this device vs the checked-in CPU golden (BASELINE.md row 3);
- gradient consistency (detail.grad_check): inverse-rendering gradient on
  a mesh scene on this device (CUDA traversal) vs the host CPU (jnp
  traversal).

Rays/s counts every traced ray: camera rays plus per-bounce continuation
and NEE shadow rays (the standard wavefront metric); per-depth alive-ray
fractions and an alive-weighted effective rays/s are reported alongside
so the nominal count stays honest. No baseline is stored yet, so
vs_baseline is null.

env: BENCH_RES, BENCH_SPP, BENCH_PASSES, BENCH_CHUNK,
     BENCH_MESH=0 / BENCH_MESH870=0 / BENCH_FLAGSHIP=0 / BENCH_LEGACY=0 /
     BENCH_CANONICAL=0 / BENCH_DEEP512=0 / BENCH_GOLDEN=0 / BENCH_GRAD=0
     to skip blocks, BENCH_MESH_SUBDIV, BENCH_MESH_RES, BENCH_MESH_SPP,
     BENCH_MESH_CAP / BENCH_MESH870_CAP (octree leaf capacities),
     BENCH_CANONICAL_RES / BENCH_CANONICAL_SPP.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np


def _env(name, default):
    return int(os.environ.get(name, str(default)))


def bench_cornell(res, spp, max_depth=4):
    import jax
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.models import integrator as integ
    from __graft_entry__ import _cornell_setup

    scene, camera, cfg = _cornell_setup(res=res, spp=spp)
    cfg = integ.RenderConfig(
        resolution=(res, res),
        sampler=integ.SamplerConfig(kind="sobol", spp=spp),
        integrator="path", max_depth=max_depth)
    filter_obj = integ.make_filter(cfg)
    sensor = integ.make_sensor(cfg)

    chunk = _env("BENCH_CHUNK", 8)

    @jax.jit
    def chunk_pass(scene, sample_idx):
        return integ.render_passes(scene, camera, cfg, filter_obj, sensor,
                                   sample_idx, chunk)

    rgb, wt = chunk_pass(scene, jnp.uint32(0))
    jax.block_until_ready((rgb, wt))

    n_timed = _env("BENCH_PASSES", 32)
    n_chunks = max(1, n_timed // chunk)
    n_timed = n_chunks * chunk
    # Best-of-2 timed sweeps over disjoint sample-index ranges (every timed
    # pass renders new samples); min-over-repeats estimates the steady
    # state.
    dt = float("inf")
    for rep in range(2):
        base = (rep + 1) * (1 << 20)
        t0 = time.perf_counter()
        for i in range(n_chunks):
            rgb, wt = chunk_pass(scene, jnp.uint32(base + i * chunk))
        jax.block_until_ready((rgb, wt))
        dt = min(dt, time.perf_counter() - t0)

    alive = np.asarray(jax.jit(lambda s: integ.alive_fractions(
        s, camera, cfg))(scene))

    n_pixels = res * res
    rays_per_sample = 1 + (max_depth - 1) + max_depth
    rays_per_sec = n_pixels * n_timed * rays_per_sample / dt
    # alive-weighted ray count: 1 camera ray + continuation rays at depths
    # 1..D-1 + NEE shadow rays at depths 0..D-1, each weighted by the
    # measured alive fraction (dead rays ride the lockstep scan as masked
    # work — the nominal count stays the headline, this keeps it honest)
    eff_rays_per_sample = (1.0 + float(sum(alive[1:max_depth]))
                           + float(sum(alive[:max_depth])))
    detail = {
        "rays_per_sec": rays_per_sec,
        "effective_rays_per_sec": round(
            n_pixels * n_timed * eff_rays_per_sample / dt, 1),
        "passes_timed": n_timed,
        "sec_per_spp_pass": round(dt / n_timed, 6),
        "est_sec_full_1024spp": round(dt / n_timed * spp, 2),
        "alive_frac_per_depth": [round(float(a), 4) for a in alive],
    }

    if os.environ.get("BENCH_LEGACY", "1") != "0":
        # Round-1 launch shape: one render_pass per spp, no chunk/scan.
        @jax.jit
        def one_pass(scene, sample_idx):
            return integ.render_pass(scene, camera, cfg, filter_obj,
                                     sensor, sample_idx)

        rgb, wt_l = one_pass(scene, jnp.uint32(0))
        jax.block_until_ready((rgb, wt_l))
        n_legacy = min(n_timed, 16)
        t0 = time.perf_counter()
        for i in range(n_legacy):
            rgb, wt_l = one_pass(scene, jnp.uint32(i + 1))
        jax.block_until_ready((rgb, wt_l))
        dt_l = time.perf_counter() - t0
        detail["legacy_unchunked"] = {
            "rays_per_sec": round(
                n_pixels * n_legacy * rays_per_sample / dt_l, 1),
            "passes_timed": n_legacy,
            "sec_per_spp_pass": round(dt_l / n_legacy, 6),
        }
    return detail


# Octree leaf capacities of the mesh cells (see PERF.md for the sweep).
MESH_CAP = 40
MESH870_CAP = 40


def _memory():
    """Device-memory block from the runtime's allocator statistics."""
    import jax
    stats = jax.devices()[0].memory_stats()
    if not stats:
        raise RuntimeError("memory_stats() is empty on this device")
    return {k + "_mb": round(stats[k] / 2**20)
            for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
            if k in stats}


def dragon_scene(subdiv=7, cap=MESH_CAP):
    """The 327k-tri displaced icosphere (``mesh``, flagship and deep512)."""
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.models.scene import Scene
    from computational_ray_tracer_tpu.ops import triangle as trimod
    from computational_ray_tracer_tpu.utils import mesh_gen

    v, f, uv = mesh_gen.displaced_icosphere(subdiv)
    mesh = trimod.MeshData.build(v, f, uvs=uv)
    return Scene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.75, 0.71, 0.62)}],
        lights=[{"kind": "distant", "direction": (-0.4, -1.0, 0.5),
                 "rgb": (1.0, 1.0, 1.0), "scale": 4.0},
                {"kind": "ambient", "spd_named": "stdillum-D65",
                 "scale": 0.15}],
        mesh=(mesh, jnp.zeros((mesh.n_triangles,), jnp.int32)),
        use_octree=True, octree_capacity=cap)


def dragon_camera(res, **lens):
    from computational_ray_tracer_tpu.ops import camera as cam
    return cam.PerspectiveCamera.create((0, 0.5, -3.4), (res, res),
                                        fov_y=40.0, look_at=(0, 0, 0),
                                        **lens)


def direct_cfg(res, spp):
    """Direct lighting (1 camera + 1 shadow ray per sample): ``mesh`` and
    ``mesh870``."""
    from computational_ray_tracer_tpu.models import integrator as integ
    return integ.RenderConfig(
        resolution=(res, res),
        sampler=integ.SamplerConfig(kind="sobol", spp=spp),
        integrator="direct", max_depth=1)


def mesh870_setup(res, cap=MESH870_CAP, **stand_in):
    """(scene, camera) of the 872k-tri x15-scale irregular mesh
    (``stand_in`` goes to mesh_gen.dragon_stand_in, e.g. target_tris)."""
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.models.scene import Scene
    from computational_ray_tracer_tpu.ops import camera as cam
    from computational_ray_tracer_tpu.ops import triangle as trimod
    from computational_ray_tracer_tpu.utils import mesh_gen

    v, f, uv = mesh_gen.dragon_stand_in(**stand_in)
    mesh = trimod.MeshData.build(v, f, uvs=uv)
    scene = Scene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.7, 0.64, 0.52)}],
        lights=[{"kind": "distant", "direction": (-0.4, -1.0, 0.5),
                 "rgb": (1.0, 1.0, 1.0), "scale": 4.0},
                {"kind": "ambient", "spd_named": "stdillum-D65",
                 "scale": 0.15}],
        mesh=(mesh, jnp.zeros((mesh.n_triangles,), jnp.int32)),
        use_octree=True, octree_capacity=cap)
    camera = cam.PerspectiveCamera.create((0, 12, -52), (res, res),
                                          fov_y=45.0, look_at=(0, -1, 0))
    return scene, camera


def flagship_setup(scene, res, spp):
    """(scene, camera, cfg) of the flagship: the dragon scene textured,
    thin-lens camera, stratified path/MIS at depth 4, compacted."""
    import dataclasses as dc
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.models import integrator as integ
    from computational_ray_tracer_tpu.ops import color as colorlib
    from computational_ray_tracer_tpu.utils import mesh_gen

    # texture the dragon (uvmap.png analog: procedural checker through the
    # rgb2spec sigmoid table) and light it like the reference scene
    tex = mesh_gen.checker_texture(256)
    img = jnp.asarray(np.asarray(tex, np.float32))
    table = colorlib.RGBToSpectrumTable.srgb()
    tex_coeffs = table.lookup(img.reshape(-1, 3)).reshape(*img.shape)
    mats = dc.replace(scene.materials,
                      use_texture=jnp.ones_like(scene.materials.use_texture))
    scene = dc.replace(scene, texture=tex_coeffs, materials=mats)
    camera = dragon_camera(res, lens_radius=0.02, focal_distance=3.4)
    cfg = integ.RenderConfig(
        resolution=(res, res),
        sampler=integ.SamplerConfig(kind="stratified", spp=max(spp, 4),
                                    xs=2, ys=2),
        integrator="path", max_depth=4,
        filter_name="gaussian", filter_radius=(0.5, 0.5),
        compact=True, compact_quantum=8192)
    return scene, camera, cfg


def deep512_cfg(spp=2):
    """512^2 depth-8 path tracing through render(), compacted."""
    from computational_ray_tracer_tpu.models import integrator as integ
    return integ.RenderConfig(
        resolution=(512, 512),
        sampler=integ.SamplerConfig(kind="sobol", spp=spp),
        integrator="path", max_depth=8,
        compact=True, compact_quantum=8192)


def grad_setup():
    """(scene, camera, cfg) of the gradient check: 1280 triangles through
    the octree at 32^2."""
    from computational_ray_tracer_tpu.models import integrator as integ
    scene = dragon_scene(3, 16)
    cfg = integ.RenderConfig(
        resolution=(32, 32),
        sampler=integ.SamplerConfig(kind="sobol", spp=2),
        integrator="path", max_depth=2)
    return scene, dragon_camera(32), cfg


def _time_passes(scene, camera, cfg, n_passes):
    """Compile + first pass, then the mean of ``n_passes`` warm
    render_pass calls at fresh sample indices."""
    import jax
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.models import integrator as integ

    filter_obj = integ.make_filter(cfg)
    sensor = integ.make_sensor(cfg)

    @jax.jit
    def one_pass(scene, sample_idx):
        return integ.render_pass(scene, camera, cfg, filter_obj, sensor,
                                 sample_idx)

    t0 = time.perf_counter()
    rgb, wt = one_pass(scene, jnp.uint32(0))
    jax.block_until_ready((rgb, wt))
    compile_dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(n_passes):
        rgb, wt = one_pass(scene, jnp.uint32(i + 1))
    jax.block_until_ready((rgb, wt))
    return compile_dt, (time.perf_counter() - t0) / n_passes, rgb


def bench_dragon():
    res = _env("BENCH_MESH_RES", 512)
    spp = _env("BENCH_MESH_SPP", 4)
    cap = _env("BENCH_MESH_CAP", MESH_CAP)

    t0 = time.perf_counter()
    scene = dragon_scene(_env("BENCH_MESH_SUBDIV", 7), cap)
    build_dt = time.perf_counter() - t0
    compile_dt, dt, rgb = _time_passes(scene, dragon_camera(res),
                                       direct_cfg(res, spp), spp)
    # direct lighting: 1 camera ray + 1 shadow ray per sample
    return scene, {
        "n_triangles": int(scene.mesh.n_triangles),
        "leaf_cap": cap,
        "rays_per_sec": round(res * res * 2 / dt, 1),
        "sec_per_spp_pass": round(dt, 4),
        "octree": scene.octree.info(),
        "scene_build_sec": round(build_dt, 1),
        "compile_sec": round(compile_dt, 1),
        "img_mean": round(float(np.mean(rgb)), 5),
    }


def bench_dragon870():
    """Reference-scale irregular mesh: the ~870k-tri x15-scale dragon
    stand-in (mesh_gen.dragon_stand_in — blob radii and subdivision levels
    spanning orders of magnitude, tri-area p99/p1 ~1300x) through the
    octree, direct lighting at 512^2, with the leaf-table footprint and
    device memory peak recorded."""
    res = _env("BENCH_MESH_RES", 512)
    spp = _env("BENCH_MESH_SPP", 4)
    cap = _env("BENCH_MESH870_CAP", MESH870_CAP)

    t0 = time.perf_counter()
    scene, camera = mesh870_setup(res, cap)
    build_dt = time.perf_counter() - t0
    compile_dt, dt, rgb = _time_passes(scene, camera, direct_cfg(res, spp),
                                       spp)
    return {
        "n_triangles": int(scene.mesh.n_triangles),
        "leaf_cap": cap,
        "rays_per_sec": round(res * res * 2 / dt, 1),
        "sec_per_spp_pass": round(dt, 4),
        "octree": scene.octree.info(),
        "leaf_table_mb": round(int(scene.octree.leaf_tris.size) * 4 / 2**20),
        "memory": _memory(),
        "scene_build_sec": round(build_dt, 1),
        "compile_sec": round(compile_dt, 1),
        "img_mean": round(float(np.mean(rgb)), 5),
    }


def bench_dragon2m():
    """Opt-in (BENCH_MESH2M=1) 2,000,000-triangle scale probe: the same
    irregular-mesh pipeline at 2.3x the canonical triangle count."""
    res = _env("BENCH_MESH_RES", 512)
    t0 = time.perf_counter()
    scene, camera = mesh870_setup(res, MESH870_CAP, target_tris=2_000_000)
    build_dt = time.perf_counter() - t0
    compile_dt, dt, rgb = _time_passes(scene, camera, direct_cfg(res, 4), 4)
    return {
        "n_triangles": int(scene.mesh.n_triangles),
        "rays_per_sec": round(res * res * 2 / dt, 1),
        "sec_per_spp_pass": round(dt, 4),
        "octree": scene.octree.info(),
        "leaf_table_mb": round(int(scene.octree.leaf_tris.size) * 4 / 2**20),
        "memory": _memory(),
        "scene_build_sec": round(build_dt, 1),
        "compile_sec": round(compile_dt, 1),
        "img_mean": round(float(np.mean(rgb)), 5),
    }


def bench_flagship(scene=None):
    """The reference's canonical end-to-end workload
    (RayTracerTestApp.h:70-189): dragon-class textured mesh + octree +
    thin-lens perspective camera + stratified sampling + path/MIS +
    gaussian filter + sensor resolve, 512x512, compacted."""
    import jax
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.models import integrator as integ

    res = _env("BENCH_MESH_RES", 512)
    spp = _env("BENCH_MESH_SPP", 4)
    if scene is None:
        scene = dragon_scene(_env("BENCH_MESH_SUBDIV", 7),
                             _env("BENCH_MESH_CAP", MESH_CAP))
    scene, camera, cfg = flagship_setup(scene, res, spp)
    depth = cfg.max_depth
    filter_obj = integ.make_filter(cfg)
    sensor = integ.make_sensor(cfg)

    def one_pass(scene, sample_idx):
        return integ.render_pass_compact(scene, camera, cfg, filter_obj,
                                         sensor, sample_idx)

    t0 = time.perf_counter()
    rgb, wt = one_pass(scene, jnp.uint32(0))
    jax.block_until_ready((rgb, wt))
    compile_dt = time.perf_counter() - t0
    # >= 8 warm passes: the compacted loop's occasional per-bucket-size
    # compiles amortize poorly over a short window
    n_timed = max(spp, 8)
    t0 = time.perf_counter()
    for i in range(n_timed):
        rgb, wt = one_pass(scene, jnp.uint32(i + 1))
    jax.block_until_ready((rgb, wt))
    dt = (time.perf_counter() - t0) / n_timed

    rays_per_sample = 1 + (depth - 1) + depth
    return {
        "rays_per_sec": round(res * res * rays_per_sample / dt, 1),
        "sec_per_spp_pass": round(dt, 4),
        "passes_timed": n_timed,
        "compile_sec": round(compile_dt, 1),
        "img_mean": round(float(jnp.mean(rgb)), 5),
    }


def bench_canonical():
    """The reference's canonical workload as one committed parity block
    : 500x500, stratified 10x10 spp, the 872k-tri
    x15-scale mesh through an octree at the reference's leaf cap 40,
    thin-lens perspective (lens 50 / focal 800), triangle half-pixel
    filter, XYZ sensor + D65, the reference's direct Li (ambient F1 +
    cosine white light, no shadow rays) — RayTracerTestApp.h:103-207.
    Emits the PNG + per-pass wall time + rays/s + a CPU-golden gate."""
    import numpy as np
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "benchmarks"))
    import canonical

    res = _env("BENCH_CANONICAL_RES", 500)
    spp = _env("BENCH_CANONICAL_SPP", 100)
    img, stats = canonical.render(res, spp, cap=40)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "benchmarks", "data")
    os.makedirs(out_dir, exist_ok=True)
    from computational_ray_tracer_tpu.utils import image
    png = os.path.join(out_dir, f"canonical_{res}.png")
    image.write_png(png, img)
    stats["png"] = os.path.relpath(png, os.path.dirname(
        os.path.abspath(__file__)))

    # CPU-golden gate: the same pipeline at 64x64 spp 4 vs the committed
    # golden (tests/golden/canonical_64.npy, generated on CPU).
    img64, _ = canonical.render(64, 4, cap=40)
    stats["golden_gate"] = canonical.check_golden(img64)
    return stats


def bench_deep512(scene=None):
    """512^2 depth-8 render through the public render() driver, with
    cfg.compact routing the host-driven compacted bounce loop."""
    import jax
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.models import integrator as integ

    if scene is None:
        scene = dragon_scene(_env("BENCH_MESH_SUBDIV", 7),
                             _env("BENCH_MESH_CAP", MESH_CAP))
    camera = dragon_camera(512)
    cfg = deep512_cfg(spp=2)
    t0 = time.perf_counter()
    film, sensor = integ.render(scene, camera, cfg, passes=1)
    jax.block_until_ready(film.rgb_sum)
    cold = time.perf_counter() - t0
    # steady state: later passes can still hit novel compacted-bucket
    # sizes (each size compiles once); report the fastest of a few
    cfg_more = dataclasses.replace(
        cfg, sampler=dataclasses.replace(cfg.sampler, spp=4))
    warm = None
    for _ in range(3):
        t0 = time.perf_counter()
        film, sensor = integ.render(scene, camera, cfg_more, film=film,
                                    passes=1)
        jax.block_until_ready(film.rgb_sum)
        dt = time.perf_counter() - t0
        warm = dt if warm is None else min(warm, dt)
    rays = 512 * 512 * (1 + 7 + 8)
    return {"res": 512, "max_depth": 8,
            "compile_plus_first_pass_sec": round(cold, 1),
            "warm_pass_sec": round(warm, 3),
            "rays_per_sec_warm": round(rays / warm, 1),
            "img_mean": round(float(jnp.mean(
                film.rgb_sum / jnp.maximum(film.weight_sum[..., None],
                                           1e-9))), 5),
            "ok": True}


def bench_golden_gate():
    """Render the 128x128 Cornell golden config on THIS device and compare
    against the checked-in CPU golden (BASELINE.md row 3 cross-check)."""
    import jax
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from golden_scenes import golden2_cornell_path, _render

    img = _render(lambda: golden2_cornell_path(res=128, spp=4))
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "golden", "config2_cornell_path_128.npy")
    golden = np.load(path)
    atol = 2e-3 * max(float(golden.max()), 1e-3)
    max_diff = float(np.abs(img - golden).max())
    return {"max_abs_diff": round(max_diff, 6),
            "atol": round(atol, 6),
            "ok": bool(max_diff <= atol)}


def grad_check(atol_rel=1e-3):
    """d(mean rgb)/d(albedo) on the 1280-tri octree scene, computed by one
    jitted function on this device (CUDA traversal on a GPU) and again on
    the host CPU (jnp traversal). Hit ids carry zero tangents on both
    paths, so the reparameterized gradients must agree."""
    import jax
    import jax.numpy as jnp
    import dataclasses as dc
    from computational_ray_tracer_tpu.models import integrator as integ

    scene, camera, cfg = grad_setup()
    filter_obj = integ.make_filter(cfg)
    sensor = integ.make_sensor(cfg)

    @jax.jit
    @jax.grad
    def grad_fn(coeffs, scene_):
        s = dc.replace(scene_, materials=dc.replace(
            scene_.materials, albedo_coeffs=coeffs))
        rgb, _ = integ.render_pass(s, camera, cfg, filter_obj, sensor,
                                   jnp.uint32(0))
        return jnp.mean(rgb)

    coeffs = scene.materials.albedo_coeffs
    g_dev = np.asarray(grad_fn(coeffs, scene))
    cpu = jax.devices("cpu")[0]
    g_cpu = np.asarray(grad_fn(jax.device_put(coeffs, cpu),
                               jax.device_put(scene, cpu)))
    scale = max(float(np.abs(g_cpu).max()), 1e-12)
    max_rel = float(np.abs(g_dev - g_cpu).max() / scale)
    return {"grad_max_rel_diff": max_rel,
            "grad_linf_cpu": float(np.abs(g_cpu).max()),
            "ok": bool(max_rel < atol_rel)}


def device_info():
    """The device every result ran on; fails unless it is a GPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {dev.platform}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def main():
    from computational_ray_tracer_tpu.utils import compile_cache
    compile_cache.enable()
    device = device_info()

    res = _env("BENCH_RES", 256)
    spp = _env("BENCH_SPP", 1024)
    cornell = bench_cornell(res, spp)
    detail = {"device": device, **cornell}

    dragon = None
    if os.environ.get("BENCH_MESH", "1") != "0":
        dragon, detail["mesh"] = bench_dragon()
    if os.environ.get("BENCH_MESH870", "1") != "0":
        detail["mesh870"] = bench_dragon870()
    if os.environ.get("BENCH_MESH2M", "0") == "1":     # opt-in scale probe
        detail["mesh2m"] = bench_dragon2m()
    if os.environ.get("BENCH_FLAGSHIP", "1") != "0":
        detail["flagship"] = bench_flagship(dragon)
    if os.environ.get("BENCH_CANONICAL", "1") != "0":
        detail["canonical"] = bench_canonical()
    if os.environ.get("BENCH_DEEP512", "1") != "0":
        detail["deep512"] = bench_deep512(dragon)
    if os.environ.get("BENCH_GOLDEN", "1") != "0":
        detail["golden_gate"] = bench_golden_gate()
    if os.environ.get("BENCH_GRAD", "1") != "0":
        detail["grad_check"] = grad_check()

    rays_per_sec = detail.pop("rays_per_sec")
    print(json.dumps({
        "metric": f"rays_per_sec_cornell_{res}x{res}_path4",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": None,
        "detail": detail,
    }))


if __name__ == "__main__":
    main()
