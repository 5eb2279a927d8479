"""Multi-device WEAK-scaling harness for the sharded renderer
(BASELINE.md row 4).

Design: per-device workload is CONSTANT — at dp devices the image is
(res x res*dp) with pixels sharded over dp, so every device renders
exactly res^2 pixels per pass regardless of dp. Ideal weak scaling is
flat wall time; efficiency = T(dp=1) / T(dp).

METHODOLOGY NOTE (what this file's output can and cannot show).
On a *virtual* CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=8)
the virtual devices share the host's cores, so wall-clock "efficiency" is
dominated by host oversubscription, NOT by the renderer or its
collectives. What the virtual mesh DOES demonstrate:

  1. correctness: the sharded image is asserted bit-identical to the
     single-device render of the same image (the determinism contract —
     every sample value is a pure function of (seed, pixel, sample, dim),
     so placement cannot change the picture);
  2. the collective structure compiles and runs (psum film merge over sp,
     owner-sharded pixels over dp — one psum per pass, O(1) in dp);
  3. per-device work really is constant: the per-device ray count is
     reported per row.

The >80% BASELINE target is a claim about real devices: the film psum is
the only cross-device traffic (a few MB per pass), so the expected
weak-scaling loss is the collective's time. It must be measured on GPUs
(four H100s joined by NVLink: not measured yet).

Usage: JAX_PLATFORMS=cpu \
       XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python benchmarks/scaling.py [--res 64] [--passes 4]
Writes benchmarks/scaling.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=64,
                    help="per-device image tile is res x res")
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    import numpy as np
    import jax
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.models import integrator as integ
    from computational_ray_tracer_tpu.ops import camera as cam
    from computational_ray_tracer_tpu.ops import film as filmmod
    from computational_ray_tracer_tpu.parallel import sharding as par
    from __graft_entry__ import _cornell_setup

    res = args.res
    devices = jax.devices()
    dps = [d for d in (1, 2, 4, 8) if d <= len(devices)]
    rows = []
    t_base = None
    rays_per_sample = 1 + 3 + 4          # path, depth 4
    for dp in dps:
        # weak scaling: total image (res, res*dp); each device owns a
        # res x res pixel block (P('dp') on the flat pixel axis).
        w, h = res, res * dp
        scene, _, _ = _cornell_setup(res=res, spp=args.passes)
        camera = cam.PerspectiveCamera.create(
            (0.0, 0.0, -2.4), (w, h), fov_y=60.0, look_at=(0.0, 0.0, 0.0))
        cfg = integ.RenderConfig(
            resolution=(w, h),
            sampler=integ.SamplerConfig(kind="sobol", spp=args.passes),
            integrator="path", max_depth=4)
        mesh = par.make_mesh(n_dp=dp, n_sp=1, devices=devices[:dp])
        step, _ = par.make_sharded_render(scene, camera, cfg, mesh)
        film = filmmod.Film.create(cfg.resolution)
        film = step(scene, film, 0)                      # compile
        jax.block_until_ready(film.rgb_sum)
        t0 = time.perf_counter()
        for i in range(args.passes):
            film = step(scene, film, i + 1)
        jax.block_until_ready(film.rgb_sum)
        dt = time.perf_counter() - t0
        if t_base is None:
            t_base = dt

        # correctness gate: sharded == single-device, same config
        mesh1 = par.make_mesh(n_dp=1, n_sp=1, devices=devices[:1])
        step1, _ = par.make_sharded_render(scene, camera, cfg, mesh1)
        f1 = filmmod.Film.create(cfg.resolution)
        for i in range(args.passes + 1):
            f1 = step1(scene, f1, i)
        # Sample VALUES are placement-invariant by construction (counter
        # RNG); XLA may still reassociate intra-pixel reductions (the 8-λ
        # sensor dot) differently between the dp and single-device
        # programs, so the gate is f32-epsilon-scale, with the measured
        # diff recorded. (tests/test_sharding.py covers the bit-exact
        # configurations.)
        scale = float(np.abs(np.asarray(f1.rgb_sum)).max()) or 1.0
        max_diff = float(np.abs(np.asarray(f1.rgb_sum)
                                - np.asarray(film.rgb_sum)).max())
        assert max_diff <= 4e-7 * scale, \
            f"sharded != single-device ({max_diff} vs scale {scale})"

        rows.append({
            "dp": dp, "image": [w, h],
            "pixels_per_device": res * res,
            "rays_per_device_per_pass": res * res * rays_per_sample,
            "sec_per_pass": round(dt / args.passes, 4),
            "weak_scaling_wall_ratio": round(t_base / dt, 4),
            "vs_single_device_max_abs_diff": max_diff,
        })
        print(json.dumps(rows[-1]), flush=True)

    ncpu = os.cpu_count()
    out = {
        "device": str(devices[0]), "n_devices": len(devices),
        "physical_cores": ncpu,
        "methodology": (
            "weak scaling: per-device tile fixed at res^2 pixels, image "
            "height scales with dp; ideal = flat wall time. On a virtual "
            f"CPU mesh over {ncpu} physical cores the wall ratio measures "
            "host oversubscription, not the renderer (see module "
            "docstring); the committed evidence is the per-device-constant "
            "workload and the sharded==single-device identity. The >80% "
            "BASELINE row requires a real multi-chip slice."),
        "res": res, "passes": args.passes, "scene": "cornell",
        "rows": rows,
    }
    out_path = args.out or os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scaling.json")
    with open(out_path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"wrote {out_path}", file=sys.stderr)


if __name__ == "__main__":
    main()
