"""Wavefront-compaction speedup measurement.

Renders a mixed diffuse/conductor/dielectric Cornell scene (mesh walls
through the octree + analytic spheres) at depth 8 — where the alive
fraction decays enough that carrying dead rays through the full BSDF/NEE
math dominates — with and without between-bounce compaction
(integrator.render_pass_compact), and reports the speedup. The behavior
being matched: the reference's per-pixel threads simply *finish* when a
path terminates, so dead pixels cost nothing
(/root/reference/Applications/RayTracerTestApp.h:361-366); on an
accelerator the static-shape analog is gathering the alive rays into the
smallest quantized bucket each bounce.

Sample values are identical either way (tests/test_compaction.py); this
harness only measures time.

Usage: python benchmarks/compaction_bench.py [--res 256] [--depth 8]
       [--passes 8] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_scene(use_octree):
    """Cornell walls (mesh) + mirror + glass spheres: three BSDF kinds so
    per-bounce material mixes stay heterogeneous through depth 8."""
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.models.scene import Scene
    from computational_ray_tracer_tpu.ops import triangle as trimod
    from computational_ray_tracer_tpu.ops import shapes as shp
    from computational_ray_tracer_tpu.utils import mesh_gen

    pos, idx, uv, mats, (lc, le1, le2) = mesh_gen.cornell_box(2.0)
    mesh = trimod.MeshData.build(pos, idx, uvs=uv)
    return Scene.build(
        use_octree=use_octree,
        materials=[
            {"kind": "diffuse", "albedo_rgb": (0.73, 0.73, 0.73)},
            {"kind": "diffuse", "albedo_rgb": (0.65, 0.05, 0.05)},
            {"kind": "diffuse", "albedo_rgb": (0.12, 0.45, 0.15)},
            {"kind": "diffuse", "albedo_rgb": (0.0, 0.0, 0.0),
             "emission_rgb": (1.0, 0.85, 0.6), "emission_scale": 6.0},
            {"kind": "conductor", "albedo_rgb": (1.0, 1.0, 1.0),
             "metal": "metal-Ag"},
            {"kind": "dielectric", "eta": 1.5},
        ],
        lights=[{"kind": "quad", "corner": tuple(lc), "edge1": tuple(le1),
                 "edge2": tuple(le2), "rgb": (1.0, 0.85, 0.6),
                 "scale": 6.0}],
        spheres=[{"radius": 0.4,
                  "transform": shp.make_transform((-0.45, -0.6, 0.35)),
                  "material": 4},
                 {"radius": 0.35,
                  "transform": shp.make_transform((0.45, -0.65, -0.25)),
                  "material": 5}],
        mesh=(mesh, jnp.asarray(mats)),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--passes", type=int, default=8)
    ap.add_argument("--quantum", type=int, default=1024)
    ap.add_argument("--octree", type=int, default=0,
                    help="route the Cornell walls through the octree")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    import numpy as np
    import jax
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.models import integrator as integ
    from computational_ray_tracer_tpu.ops import camera as cam

    scene = build_scene(bool(args.octree))
    res = args.res
    camera = cam.PerspectiveCamera.create((0, 0, -2.8), (res, res),
                                          fov_y=50.0, look_at=(0, 0, 0))
    cfg = integ.RenderConfig(
        resolution=(res, res),
        sampler=integ.SamplerConfig(kind="sobol", spp=args.passes),
        integrator="path", max_depth=args.depth,
        compact=True, compact_quantum=args.quantum)
    filter_obj = integ.make_filter(cfg)
    sensor = integ.make_sensor(cfg)

    alive = np.asarray(jax.jit(lambda s: integ.alive_fractions(
        s, camera, cfg))(scene))

    @jax.jit
    def full_pass(scene, i):
        return integ.render_pass(scene, camera, cfg, filter_obj, sensor, i)

    def compact_pass(scene, i):
        return integ.render_pass_compact(scene, camera, cfg, filter_obj,
                                         sensor, i)

    def timeit(fn, label):
        rgb, wt = fn(scene, jnp.uint32(0))       # compile / warm cache
        jax.block_until_ready(rgb)
        # one more warm pass so compact's per-bucket compiles are all paid
        rgb, wt = fn(scene, jnp.uint32(1))
        jax.block_until_ready(rgb)
        t0 = time.perf_counter()
        for i in range(args.passes):
            rgb, wt = fn(scene, jnp.uint32(i + 2))
        jax.block_until_ready(rgb)
        dt = (time.perf_counter() - t0) / args.passes
        print(f"{label}: {dt:.4f}s per spp pass", file=sys.stderr)
        return dt, float(jnp.mean(rgb))

    dt_full, mean_full = timeit(full_pass, "full-wavefront")
    dt_comp, mean_comp = timeit(compact_pass, "compacted")

    out = {
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "res": res, "max_depth": args.depth, "passes": args.passes,
        "compact_quantum": args.quantum, "octree": bool(args.octree),
        "alive_frac_per_depth": [round(float(a), 4) for a in alive],
        "sec_per_pass_full": round(dt_full, 4),
        "sec_per_pass_compact": round(dt_comp, 4),
        "speedup": round(dt_full / dt_comp, 3),
        "img_mean_full": round(mean_full, 6),
        "img_mean_compact": round(mean_comp, 6),
    }
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
