"""The CUDA octree traversal against the plain jnp traversal, end to end.

Times render() passes of the mesh cells with the traversal op as the
program runs it (the CUDA kernel on a GPU), then with the op swapped for
the jnp loop ``octree.octree_traverse`` inside this process, in turns
(kernel, jnp, kernel, jnp). Also sweeps the octree leaf capacity of the
``mesh`` and ``mesh870`` cells with the kernel, times the shadow-ray sort
(``scene._packet_order``) in front of the any-hit call, and records the
compiled temporary memory of one 512^2 closest-hit traversal on each path.

    python benchmarks/traversal_compare.py [--out FILE]

Needs a GPU. Prints one JSON object (and writes it to --out if given).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))


@contextlib.contextmanager
def jnp_traversal():
    """Swap the traversal op for the jnp loop for everything traced inside
    (render program caches are cleared on entry and exit)."""
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.models import integrator as integ
    from computational_ray_tracer_tpu.ops import octree as octmod
    from computational_ray_tracer_tpu.ops import traversal

    def closest(o, d, t_max, tree, mesh, tri_mask=None):
        return octmod.octree_traverse(o, d, t_max, tree, mesh, tri_mask)

    def anyhit(o, d, t_max, tree, mesh, tri_mask=None):
        t, tri, *_ = octmod.octree_traverse(o, d, t_max, tree, mesh,
                                            tri_mask)
        return jnp.isfinite(t) & (tri >= 0)

    saved = traversal.closest_hit, traversal.any_hit
    _clear(integ)
    traversal.closest_hit, traversal.any_hit = closest, anyhit
    try:
        yield
    finally:
        traversal.closest_hit, traversal.any_hit = saved
        _clear(integ)


@contextlib.contextmanager
def sorted_shadow_rays():
    """Sort each any-hit wavefront by (direction octant, origin Morton
    cell) before the traversal and unsort after."""
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.models import integrator as integ
    from computational_ray_tracer_tpu.models.scene import _packet_order
    from computational_ray_tracer_tpu.ops import traversal

    plain = traversal.any_hit

    def anyhit(o, d, t_max, tree, mesh, tri_mask=None):
        shape = t_max.shape
        of, df, tf = o.reshape(-1, 3), d.reshape(-1, 3), t_max.reshape(-1)
        order = _packet_order(of, df, tf > 0.0)
        h = plain(of[order], df[order], tf[order], tree, mesh, tri_mask)
        return jnp.zeros_like(h).at[order].set(h).reshape(shape)

    _clear(integ)
    traversal.any_hit = anyhit
    try:
        yield
    finally:
        traversal.any_hit = plain
        _clear(integ)


def _clear(integ):
    integ._RENDER_PROG_CACHE.clear()
    integ._COMPACT_CACHE.clear()
    integ._BUCKET_SCHEDULE.clear()


def time_render(scene, camera, cfg, passes):
    """(cold_s, [per-pass warm seconds]) of render() one pass at a time."""
    import jax
    from computational_ray_tracer_tpu.models import integrator as integ
    cfg = dataclasses.replace(cfg, sampler=dataclasses.replace(
        cfg.sampler, spp=max(cfg.sampler.spp, passes + 1)))
    t0 = time.perf_counter()
    film, _ = integ.render(scene, camera, cfg, passes=1)
    jax.block_until_ready(film.rgb_sum)
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(passes):
        t0 = time.perf_counter()
        film, _ = integ.render(scene, camera, cfg, film=film, passes=1)
        jax.block_until_ready(film.rgb_sum)
        warm.append(time.perf_counter() - t0)
    return cold, warm


def time_canonical(passes):
    import canonical
    _, stats = canonical.render(500, passes + 1)
    return stats["compile_sec"], [stats["sec_per_sample_pass"]]


def cells():
    import bench
    dragon = bench.dragon_scene(7, bench.MESH_CAP)
    flag = bench.flagship_setup(dragon, 512, 4)
    s870, c870 = bench.mesh870_setup(512)
    return {
        "mesh": (dragon, bench.dragon_camera(512), bench.direct_cfg(512, 4)),
        "flagship": flag,
        "mesh870": (s870, c870, bench.direct_cfg(512, 4)),
    }


def kernel_vs_jnp(cell_map, passes_kernel=8, passes_jnp=2):
    out = {}
    for name, (scene, camera, cfg) in cell_map.items():
        runs = []
        for variant in ("kernel", "jnp", "kernel", "jnp"):
            ctx = jnp_traversal() if variant == "jnp" else \
                contextlib.nullcontext()
            n = passes_jnp if variant == "jnp" else passes_kernel
            with ctx:
                cold, warm = time_render(scene, camera, cfg, n)
            runs.append({"variant": variant, "cold_s": cold, "warm_s": warm})
            print(name, runs[-1], flush=True)
        out[name] = runs
    runs = []
    for variant in ("kernel", "jnp", "kernel", "jnp"):
        ctx = jnp_traversal() if variant == "jnp" else \
            contextlib.nullcontext()
        with ctx:
            cold, warm = time_canonical(
                passes_jnp if variant == "jnp" else passes_kernel)
        runs.append({"variant": variant, "cold_s": cold,
                     "warm_s_per_pass": warm[0]})
        print("canonical", runs[-1], flush=True)
    out["canonical"] = runs
    return out


def cap_sweep(passes=8):
    import bench
    out = {"mesh": {}, "mesh870": {}}
    for cap in (40, 64, 96, 192):
        scene = bench.dragon_scene(7, cap)
        cold, warm = time_render(scene, bench.dragon_camera(512),
                                 bench.direct_cfg(512, 4), passes)
        out["mesh"][cap] = {"warm_s": warm, "octree": scene.octree.info()}
        print("cap mesh", cap, warm, flush=True)
    for cap in (40, 64, 96, 160):
        scene, camera = bench.mesh870_setup(512, cap)
        cold, warm = time_render(scene, camera, bench.direct_cfg(512, 4),
                                 passes)
        out["mesh870"][cap] = {"warm_s": warm, "octree": scene.octree.info()}
        print("cap mesh870", cap, warm, flush=True)
    return out


def shadow_sort(cell_map, passes=8):
    out = {}
    for name in ("mesh", "flagship"):
        scene, camera, cfg = cell_map[name]
        runs = []
        for variant in ("plain", "sorted", "plain", "sorted"):
            ctx = sorted_shadow_rays() if variant == "sorted" else \
                contextlib.nullcontext()
            with ctx:
                _, warm = time_render(scene, camera, cfg, passes)
            runs.append({"variant": variant, "warm_s": warm})
            print("sort", name, runs[-1], flush=True)
        out[name] = runs
    return out


def traversal_memory(cell_map):
    """Compiled temp bytes of one 512^2 closest-hit call, each path."""
    import jax
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.ops import octree as octmod
    from computational_ray_tracer_tpu.ops import traversal
    out = {}
    for name in ("mesh", "mesh870"):
        scene = cell_map[name][0]
        n = 512 * 512
        o = jnp.zeros((n, 3))
        d = jnp.ones((n, 3))
        t = jnp.full((n,), jnp.inf)
        for label, fn in (("kernel", traversal.closest_hit),
                          ("jnp", octmod.octree_traverse)):
            mem = jax.jit(lambda o, d, t: fn(o, d, t, scene.octree,
                                             scene.mesh)).lower(
                o, d, t).compile().memory_analysis()
            out[f"{name}_{label}_temp_bytes"] = mem.temp_size_in_bytes
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    args = ap.parse_args()

    import jax
    import bench
    from computational_ray_tracer_tpu.utils import compile_cache
    compile_cache.enable()
    device = bench.device_info()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    result = {"device": device, "card": card, "jax": jax.__version__}
    cell_map = cells()
    result["memory"] = traversal_memory(cell_map)
    print(result["memory"], flush=True)
    result["kernel_vs_jnp"] = kernel_vs_jnp(cell_map)
    result["shadow_sort"] = shadow_sort(cell_map)
    result["cap_sweep"] = cap_sweep()
    result["peak_bytes_in_use"] = jax.devices()[0].memory_stats()[
        "peak_bytes_in_use"]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
