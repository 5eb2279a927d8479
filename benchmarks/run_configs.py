"""Run the five BASELINE.json benchmark configs end-to-end and emit one
JSON report (benchmarks/configs_report.json + stdout).

Usage:  python benchmarks/run_configs.py [--scale small|full]

small (default): CPU-friendly resolutions for CI; full: the BASELINE.json
sizes for GPU measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _timer():
    t0 = time.perf_counter()
    return lambda: time.perf_counter() - t0


def warm_cold_render(scene, camera, cfg, chunk, rays_per_pass):
    """Cold/warm split: one timed chunk that
    includes compilation, then the remaining passes timed warm. Returns
    (film, sensor, timing dict with BOTH numbers)."""
    import jax
    from computational_ray_tracer_tpu.models import integrator as integ

    spp = cfg.sampler.spp
    chunk = min(chunk, spp)
    el = _timer()
    film, sensor = integ.render(scene, camera, cfg, passes=chunk,
                                chunk=chunk)
    jax.block_until_ready(film.rgb_sum)
    cold = el()
    warm_passes = spp - chunk
    warm = 0.0
    if warm_passes > 0:
        el = _timer()
        film, sensor = integ.render(scene, camera, cfg, film=film,
                                    chunk=chunk)
        jax.block_until_ready(film.rgb_sum)
        warm = el()
    timing = {
        "seconds": round(cold + warm, 3),
        "compile_plus_first_chunk_sec": round(cold, 3),
        "warm_sec": round(warm, 3),
        "warm_passes": warm_passes,
    }
    if warm_passes > 0:
        timing["warm_rays_per_sec"] = round(
            rays_per_pass * warm_passes / warm, 1)
        timing["warm_sec_per_pass"] = round(warm / warm_passes, 4)
    return film, sensor, timing


def config1_sphere_direct(scale):
    """Diffuse sphere + point light, perspective camera, direct lighting."""
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.models.scene import Scene
    from computational_ray_tracer_tpu.models import integrator as integ
    from computational_ray_tracer_tpu.ops import camera as cam
    from computational_ray_tracer_tpu.ops import shapes as shp

    res = 256 if scale == "full" else 64
    spp = 16
    scene = Scene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.6, 0.3, 0.25)}],
        lights=[{"kind": "point", "position": (3.0, 4.0, -3.0),
                 "rgb": (1.0, 1.0, 1.0), "scale": 50.0}],
        spheres=[{"radius": 1.0, "transform": shp.make_transform((0, 0, 0)),
                  "material": 0}])
    camera = cam.PerspectiveCamera.create((0, 0, -4), (res, res), fov_y=40.0,
                                          look_at=(0, 0, 0))
    cfg = integ.RenderConfig(resolution=(res, res),
                             sampler=integ.SamplerConfig(kind="stratified",
                                                         spp=spp),
                             integrator="direct", max_depth=1)
    # direct lighting traces 2 rays per sample (camera + NEE shadow)
    film, sensor, timing = warm_cold_render(scene, camera, cfg,
                                            chunk=max(spp // 4, 1),
                                            rays_per_pass=res * res * 2)
    img = np.asarray(film.resolve(sensor))
    return {"res": res, "spp": spp, **timing,
            "img_mean": float(img.mean())}


def config2_cornell_path(scale):
    """Cornell box, Lambertian + area light, path tracing with NEE."""
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.models.scene import Scene
    from computational_ray_tracer_tpu.models import integrator as integ
    from computational_ray_tracer_tpu.ops import camera as cam
    from computational_ray_tracer_tpu.ops import triangle as trimod
    from computational_ray_tracer_tpu.utils import mesh_gen

    res = 256 if scale == "full" else 64
    spp = 64 if scale == "full" else 16
    pos, idx, uv, mats, (lc, le1, le2) = mesh_gen.cornell_box(2.0)
    mesh = trimod.MeshData.build(pos, idx, uvs=uv)
    scene = Scene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.73, 0.73, 0.73)},
                   {"kind": "diffuse", "albedo_rgb": (0.65, 0.05, 0.05)},
                   {"kind": "diffuse", "albedo_rgb": (0.12, 0.45, 0.15)},
                   {"kind": "diffuse", "albedo_rgb": (0, 0, 0),
                    "emission_rgb": (1.0, 0.85, 0.6),
                    "emission_scale": 6.0}],
        lights=[{"kind": "quad", "corner": tuple(lc), "edge1": tuple(le1),
                 "edge2": tuple(le2), "rgb": (1.0, 0.85, 0.6),
                 "scale": 6.0}],
        mesh=(mesh, jnp.asarray(mats)), use_octree=False)
    camera = cam.PerspectiveCamera.create((0, 0, -2.8), (res, res),
                                          fov_y=50.0, look_at=(0, 0, 0))
    cfg = integ.RenderConfig(resolution=(res, res),
                             sampler=integ.SamplerConfig(kind="sobol",
                                                         spp=spp),
                             integrator="path", max_depth=4)
    film, sensor, timing = warm_cold_render(
        scene, camera, cfg, chunk=min(max(spp // 4, 1), 16),
        rays_per_pass=res * res * (1 + 3 + 4))   # camera + bounces + NEE
    img = np.asarray(film.resolve(sensor))
    left = img[:, : res // 8]
    right = img[:, -res // 8:]
    return {"res": res, "spp": spp, **timing,
            "img_mean": float(img.mean()),
            "bleed_ok": bool(left[..., 0].mean() > left[..., 1].mean()
                             and right[..., 1].mean() > right[..., 0].mean())}


def config3_mesh_octree_textured(scale):
    """Triangle-mesh scene via octree acceleration + textured material."""
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.models.scene import Scene
    from computational_ray_tracer_tpu.models import integrator as integ
    from computational_ray_tracer_tpu.ops import camera as cam
    from computational_ray_tracer_tpu.ops import triangle as trimod
    from computational_ray_tracer_tpu.utils import mesh_gen

    res = 512 if scale == "full" else 64
    spp = 16 if scale == "full" else 4
    el_b = _timer()
    if scale == "full":
        # BASELINE's "triangle-mesh OBJ scene via octree, textured" at the
        # repo's real mesh scale:
        # the 327,680-tri displaced icosphere + checker texture.
        v, f, uv = mesh_gen.displaced_icosphere(7)
        mesh = trimod.MeshData.build(v, f, uvs=uv)
        tex = mesh_gen.checker_texture(256)
    else:
        out = mesh_gen.uv_sphere((0.0, 0.0, 0.0), 1.0, n_theta=24,
                                 n_phi=24)
        mesh = trimod.MeshData.build(out[0], out[1],
                                     uvs=out[2] if len(out) > 2 else None)
        tex = mesh_gen.checker_texture(32)
    scene = Scene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (1.0, 1.0, 1.0),
                    "use_texture": True}],
        lights=[{"kind": "distant", "direction": (-0.3, -1.0, 0.4),
                 "rgb": (1.0, 1.0, 1.0), "scale": 40.0}],
        mesh=(mesh, jnp.zeros((mesh.n_triangles,), jnp.int32)),
        use_octree=True, texture_rgb=tex)
    build_sec = el_b()
    camera = cam.PerspectiveCamera.create((0, 0.6, -3.2), (res, res),
                                          fov_y=40.0, look_at=(0, 0, 0))
    cfg = integ.RenderConfig(resolution=(res, res),
                             sampler=integ.SamplerConfig(kind="independent",
                                                         spp=spp),
                             integrator="direct", max_depth=1)
    info = scene.octree.info()
    film, sensor, timing = warm_cold_render(scene, camera, cfg,
                                            chunk=max(spp // 4, 1),
                                            rays_per_pass=res * res * 2)
    img = np.asarray(film.resolve(sensor))
    return {"res": res, "spp": spp, "n_triangles": int(mesh.n_triangles),
            "octree_nodes": info["nodes"],
            "scene_build_sec": round(build_sec, 2), **timing,
            "img_mean": float(img.mean())}


def config4_spectral(scale):
    """Hero-wavelength spectral path: blackbody + measured spectra."""
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.models.scene import Scene
    from computational_ray_tracer_tpu.models import integrator as integ
    from computational_ray_tracer_tpu.ops import camera as cam
    from computational_ray_tracer_tpu.ops import shapes as shp

    from computational_ray_tracer_tpu.ops import spectrum as spec
    from computational_ray_tracer_tpu.ops import spectra_data as data

    res = 256 if scale == "full" else 48
    spp = 32 if scale == "full" else 8
    # Three spheres lit by a 2856K blackbody (illuminant A class) distant
    # light; a conductor (measured Au spectrum) + diffuse pair.
    bb = np.asarray(spec.BlackbodySpectrum(2856.0)(
        jnp.asarray(data.DENSE_LAMBDA, jnp.float32))) * 100.0
    scene = Scene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.7, 0.7, 0.7)},
                   {"kind": "conductor", "albedo_rgb": (1, 1, 1),
                    "metal": "metal-Au"},
                   {"kind": "dielectric", "albedo_rgb": (1, 1, 1),
                    "eta": 1.5}],
        lights=[{"kind": "distant", "direction": (-0.4, -1.0, 0.5),
                 "spd_dense": bb, "scale": 0.5}],
        spheres=[{"radius": 0.8,
                  "transform": shp.make_transform((-1.8, 0, 0)),
                  "material": 0},
                 {"radius": 0.8, "transform": shp.make_transform((0, 0, 0)),
                  "material": 1},
                 {"radius": 0.8,
                  "transform": shp.make_transform((1.8, 0, 0)),
                  "material": 2}])
    camera = cam.PerspectiveCamera.create((0, 0.8, -4.5), (res, res),
                                          fov_y=45.0, look_at=(0, 0, 0))
    cfg = integ.RenderConfig(resolution=(res, res),
                             sampler=integ.SamplerConfig(kind="sobol",
                                                         spp=spp),
                             integrator="path", max_depth=4,
                             lambda_mode="visible")
    film, sensor, timing = warm_cold_render(
        scene, camera, cfg, chunk=max(spp // 4, 1),
        rays_per_pass=res * res * (1 + 3 + 4))
    img = np.asarray(film.resolve(sensor))
    # Blackbody 2856K is warm: red channel should dominate blue overall.
    return {"res": res, "spp": spp, **timing,
            "img_mean": float(img.mean()),
            "color_warm_ok": bool(img[..., 0].mean() > img[..., 2].mean())}


def config5_inverse(scale):
    """Differentiable inverse rendering: recover albedo of a Cornell box
    wall from a target image via pixel-gradient descent."""
    import dataclasses as dc
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.models.scene import Scene
    from computational_ray_tracer_tpu.models import integrator as integ
    from computational_ray_tracer_tpu.models import inverse as inv
    from computational_ray_tracer_tpu.ops import camera as cam
    from computational_ray_tracer_tpu.ops import triangle as trimod
    from computational_ray_tracer_tpu.utils import mesh_gen

    steps = 300 if scale == "full" else 25
    res = 48 if scale == "full" else 32
    spp = 8 if scale == "full" else 4
    lr = 0.1 if scale == "full" else 5e-2
    fov = 70.0 if scale == "full" else 50.0
    cam_z = -2.2 if scale == "full" else -2.8
    pos, idx, uv, mats, (lc, le1, le2) = mesh_gen.cornell_box(2.0)
    mesh = trimod.MeshData.build(pos, idx, uvs=uv)

    def build(albedos):
        return Scene.build(
            materials=[{"kind": "diffuse", "albedo_rgb": albedos[0]},
                       {"kind": "diffuse", "albedo_rgb": albedos[1]},
                       {"kind": "diffuse", "albedo_rgb": albedos[2]},
                       {"kind": "diffuse", "albedo_rgb": (0, 0, 0),
                        "emission_rgb": (1.0, 0.85, 0.6),
                        "emission_scale": 6.0}],
            lights=[{"kind": "quad", "corner": tuple(lc),
                     "edge1": tuple(le1), "edge2": tuple(le2),
                     "rgb": (1.0, 0.85, 0.6), "scale": 6.0}],
            mesh=(mesh, jnp.asarray(mats)), use_octree=False)

    target_scene = build([(0.73, 0.73, 0.73), (0.65, 0.05, 0.05),
                          (0.12, 0.45, 0.15)])
    start_scene = build([(0.4, 0.4, 0.4), (0.3, 0.3, 0.3),
                         (0.3, 0.3, 0.3)])
    # Full scale uses a wide FOV from inside the box so BOTH colored
    # walls are well-observed (at the old fov-50 framing the walls were
    # thin grazing strips and their reflectance was pinned only weakly —
    # loss converged while the wall spectra didn't).
    camera = cam.PerspectiveCamera.create((0, 0, cam_z), (res, res),
                                          fov_y=fov, look_at=(0, 0, 0))
    cfg = integ.RenderConfig(resolution=(res, res),
                             sampler=integ.SamplerConfig(kind="sobol",
                                                         spp=spp),
                             integrator="path", max_depth=3)
    render_fn, _ = inv.make_render_fn(camera, cfg)
    target = render_fn(target_scene)

    step_ts = []
    el = _timer()
    recovered_scene, params, history = inv.optimize(
        start_scene, camera, cfg, inv.albedo_params(start_scene), target,
        steps=steps, lr=lr,
        callback=lambda *a, **kw: step_ts.append(time.perf_counter()))
    dt = el()
    timing = {"seconds": round(dt, 3)}
    if len(step_ts) >= 2:
        # first callback fires after step 1 (which includes compile)
        t_start = step_ts[-1] - dt
        timing["compile_plus_first_step_sec"] = round(step_ts[0] - t_start,
                                                      3)
        timing["warm_sec_per_step"] = round(
            (step_ts[-1] - step_ts[0]) / (len(step_ts) - 1), 4)

    # Recovery metric in REFLECTANCE space (sigmoid coefficient space is
    # non-unique, so a coeff MAE reads as failure even when the recovered
    # spectra match): per-material
    # |Delta reflectance| weighted by the visible-wavelength sampling pdf
    # — the distribution the renderer actually observes. The raw dense-
    # grid MAE is dominated by the 360-400/700-830 nm tails where the
    # cosh^2 importance (and every sample) is ~zero.
    from computational_ray_tracer_tpu.ops import color as colorlib
    from computational_ray_tracer_tpu.ops import spectrum as spec
    from computational_ray_tracer_tpu.ops import spectra_data as data
    lam = jnp.asarray(data.DENSE_LAMBDA, jnp.float32)
    refl_rec = colorlib.sigmoid_polynomial(
        params["albedo_coeffs"][:3, None, :], lam[None, :])[:, 0, :]
    refl_true = colorlib.sigmoid_polynomial(
        target_scene.materials.albedo_coeffs[:3, None, :],
        lam[None, :])[:, 0, :]
    w = spec.visible_wavelengths_pdf(lam)
    w = w / jnp.sum(w)
    err = jnp.abs(refl_rec - refl_true)            # (3 materials, 471)
    per_mat = [round(float(x), 5)
               for x in jnp.sum(err * w[None, :], axis=-1)]
    refl_mae = max(per_mat)
    return {"steps": steps, **timing,
            "loss_start": history[0], "loss_final": history[-1],
            "loss_reduced": bool(history[-1] < 0.3 * history[0]),
            "albedo_reflectance_mae_visible_per_material": per_mat,
            "albedo_reflectance_mae_visible_max": refl_mae,
            # The residual concentrates in the red wall's near-zero
            # green/blue reflectance, where the sigmoid parameterization
            # is tail-flat AND the warm (1.0,0.85,0.6) illuminant carries
            # little signal — an ill-conditioned direction for
            # coefficient-space descent; the well-observed white surfaces
            # recover to ~4e-3.
            "reflectance_ok": bool(refl_mae < 0.08)}


CONFIGS = [
    ("config1_sphere_direct", config1_sphere_direct),
    ("config2_cornell_path", config2_cornell_path),
    ("config3_mesh_octree_textured", config3_mesh_octree_textured),
    ("config4_spectral", config4_spectral),
    ("config5_inverse", config5_inverse),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", choices=("small", "full"), default="small")
    ap.add_argument("--only", default=None,
                    help="comma-separated config name filter")
    args = ap.parse_args()

    import jax
    from computational_ray_tracer_tpu.utils import compile_cache
    compile_cache.enable()
    report = {"scale": args.scale, "device": str(jax.devices()[0]),
              "configs": {}}
    for name, fn in CONFIGS:
        if args.only and name not in args.only.split(","):
            continue
        try:
            report["configs"][name] = fn(args.scale)
            report["configs"][name]["ok"] = True
        except Exception as e:     # keep going; report the failure
            report["configs"][name] = {"ok": False, "error": repr(e)}
        print(f"{name}: {json.dumps(report['configs'][name])}", flush=True)

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "configs_report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({"report": out,
                      "all_ok": all(c.get("ok")
                                    for c in report["configs"].values())}))


if __name__ == "__main__":
    main()
