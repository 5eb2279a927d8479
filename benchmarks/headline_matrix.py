"""Headline-config cost matrix: times one spp pass of the 256^2 Cornell
for {simple, path(MIS)} x {independent, sobol, sobol_global}, same metric
definition as bench.py (camera + bounce + NEE rays).

Usage: python benchmarks/headline_matrix.py [--res 256] [--passes 16]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--passes", type=int, default=16)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.models import integrator as integ
    from __graft_entry__ import _cornell_setup

    res = args.res
    scene, camera, _ = _cornell_setup(res=res, spp=4)
    rays_per_sample = 1 + (args.depth - 1) + args.depth
    rows = []
    for mode, kind in itertools.product(
            ("path", "simple"), ("sobol", "independent", "sobol_global")):
        cfg = integ.RenderConfig(
            resolution=(res, res),
            sampler=integ.SamplerConfig(kind=kind, spp=1024),
            integrator=mode, max_depth=args.depth)
        filter_obj = integ.make_filter(cfg)
        sensor = integ.make_sensor(cfg)

        @jax.jit
        def chunk_pass(scene, sample_idx, cfg=cfg, filter_obj=filter_obj,
                       sensor=sensor):
            return integ.render_passes(scene, camera, cfg, filter_obj,
                                       sensor, sample_idx, 8)

        t0 = time.perf_counter()
        rgb, wt = chunk_pass(scene, jnp.uint32(0))
        jax.block_until_ready((rgb, wt))
        compile_s = time.perf_counter() - t0
        n_chunks = max(1, args.passes // 8)
        t0 = time.perf_counter()
        for i in range(n_chunks):
            rgb, wt = chunk_pass(scene, jnp.uint32((i + 1) * 8))
        jax.block_until_ready((rgb, wt))
        dt = (time.perf_counter() - t0) / (n_chunks * 8)
        row = {"integrator": mode, "sampler": kind,
               "sec_per_spp_pass": round(dt, 5),
               "rays_per_sec": round(res * res * rays_per_sample / dt, 1),
               "compile_sec": round(compile_s, 1)}
        rows.append(row)
        print(json.dumps(row), flush=True)

    out = {"device": str(jax.devices()[0]), "res": res,
           "max_depth": args.depth, "rows": rows}
    out_path = args.out or os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "headline_matrix.json")
    with open(out_path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"wrote {out_path}", file=sys.stderr)


if __name__ == "__main__":
    main()
