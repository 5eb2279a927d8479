"""Smoke test of the renderer on NVIDIA GPUs: the main path, phase by phase,
through the public entry points and at the bench sizes.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the sharded render and train
                                  # step against one card, and nothing else

One-GPU phases: gpu_tests (the tests marked ``gpu``, run by pytest in a
child process before this process opens the card), device, cornell (the
headline through render() plus the 128^2 golden gate), traversal (the CUDA
kernel against the jnp traversal on the card at 512^2), render (flagship,
872k mesh, canonical frame with its golden gate, 512^2 depth 8), grad (the
gradient on the GPU against the host CPU) and kernel_present (the
traversal's custom call in the compiled flagship pass).

Every phase prints one line: its wall time, the device's peak_bytes_in_use
so far, and the card's name and power limit from nvidia-smi. A phase that
fails prints its traceback; the script then runs the remaining phases and
exits 1 without a result. With no GPU it stops at the device phase. The last
line of a good run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Acceptance thresholds (PERF.md states the reasons).
ID_AGREE_MIN = 0.9999      # share of rays whose hit ids agree
T_REL_TOL = 1e-5           # relative t difference where the ids agree
GRAD_REL_TOL = 1e-3
SHARDED_ATOL = 1e-6
# Mean of the resolved sRGB image of each scene rendered on the CPU at
# 64^2 (4 spp; deep512 2 spp). A render on the card must land within 25%
# either way: the mean barely depends on resolution and sample count.
CPU_MEANS_64 = {"cornell": 0.42266, "flagship": 0.48625, "mesh870": 0.26236,
                "canonical": 0.044776, "deep512": 0.57910}
MEAN_RANGES = {k: (0.75 * m, 1.25 * m) for k, m in CPU_MEANS_64.items()}


def card():
    """'<name>, <power limit>' of GPU 0 from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip() if out else "unknown"


def peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


class Phases:
    """Runs phases, prints one line each, remembers failures."""

    def __init__(self):
        self.failed = []
        self.card = None

    def run(self, name, fn):
        t0 = time.perf_counter()
        try:
            detail = fn()
            ok = True
        except Exception:          # reported, counted, and exit is 1
            traceback.print_exc()
            detail, ok = {}, False
            self.failed.append(name)
        wall = time.perf_counter() - t0
        try:
            peak = peak_bytes()
        except Exception:          # no device yet (device phase failed)
            peak = None
        if self.card is None:
            try:
                self.card = card()
            except (OSError, subprocess.SubprocessError):
                self.card = "nvidia-smi unavailable"
        print(f"phase={name} ok={ok} wall_s={wall:.3f} "
              f"peak_bytes_in_use={peak} card=\"{self.card}\" "
              f"{json.dumps(detail, default=_jsonable)}", flush=True)
        return ok, detail


def _jsonable(x):
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _check_mean(name, img):
    img = np.asarray(img)
    _check(np.isfinite(img).all(), f"{name}: non-finite pixels")
    lo, hi = MEAN_RANGES[name]
    mean = float(img.mean())
    _check(lo <= mean <= hi, f"{name}: image mean {mean} outside "
                             f"[{lo}, {hi}]")
    return mean


def _timed_render(scene, camera, cfg, passes, chunk=1):
    """Compile + first pass, then ``passes`` warm passes through the public
    render(); returns (film, sensor, cold_s, warm_s_per_pass)."""
    import jax
    from computational_ray_tracer_tpu.models import integrator as integ
    cfg = dataclasses.replace(cfg, sampler=dataclasses.replace(
        cfg.sampler, spp=max(cfg.sampler.spp, passes + chunk)))
    t0 = time.perf_counter()
    film, sensor = integ.render(scene, camera, cfg, passes=chunk,
                                chunk=chunk)
    jax.block_until_ready(film.rgb_sum)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    film, sensor = integ.render(scene, camera, cfg, film=film, passes=passes,
                                chunk=chunk)
    jax.block_until_ready(film.rgb_sum)
    return film, sensor, cold, (time.perf_counter() - t0) / passes


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_gpu_tests():
    """The tests that need the card, in a child process that exits before
    this process opens the card."""
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", os.path.join(ROOT, "tests")],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    tail = res.stdout.strip().splitlines()[-1:] or [""]
    print(res.stdout[-4000:], res.stderr[-2000:], sep="\n", flush=True)
    _check(res.returncode == 0, f"pytest -m gpu exited {res.returncode}")
    return {"summary": tail[0]}


def phase_device():
    import jax
    from computational_ray_tracer_tpu.utils import compile_cache
    devs = jax.devices()
    _check(devs[0].platform == "gpu",
           f"no GPU: JAX runs on {devs[0].platform}")
    cache = compile_cache.enable()
    return {"jax": jax.__version__, "platform": devs[0].platform,
            "kind": devs[0].device_kind, "count": len(devs),
            "compile_cache": cache}


def phase_cornell():
    import bench
    from __graft_entry__ import _cornell_setup

    scene, camera, cfg = _cornell_setup(res=256, spp=16)
    film, sensor, cold, warm = _timed_render(scene, camera, cfg, passes=8,
                                             chunk=8)
    mean = _check_mean("cornell", film.resolve(sensor))
    gate = bench.bench_golden_gate()
    _check(gate["ok"], f"cornell golden gate failed: {gate}")
    return {"res": 256, "cold_s": cold, "warm_s_per_pass": warm,
            "img_mean": mean, "golden_gate": gate}


def _wavefronts(scene, camera, res):
    """(name, o, d, t_max, anyhit) at the card's real widths: the camera
    wavefront, one bounce from its hits (diffuse directions) and shadow
    rays from those hits toward the distant light. Built from the jnp
    traversal's hits so both sides see the same rays."""
    import jax
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.ops import octree as octmod
    from computational_ray_tracer_tpu.ops import triangle as trimod

    n = res * res
    pix = jnp.arange(n)
    px = jnp.stack([(pix % res) + 0.5, (pix // res) + 0.5], -1)
    o, d = camera.generate_rays(px.astype(jnp.float32),
                                jnp.full((n, 2), 0.5, jnp.float32))
    t_inf = jnp.full((n,), jnp.inf)
    t, tri, b1, b2, _ = jax.jit(octmod.octree_traverse)(
        o, d, t_inf, scene.octree, scene.mesh)
    si = trimod.mesh_surface(o, d, t, tri, b1, b2, scene.mesh)
    hit = tri >= 0
    eps = 1e-4 * (jnp.max(jnp.abs(si.p), -1) + 1.0)
    o2 = si.p + si.n * eps[:, None]
    r = jax.random.normal(jax.random.PRNGKey(0), (n, 3))
    r = r / jnp.linalg.norm(r, axis=-1, keepdims=True)
    d2 = si.n + r
    d2 = d2 / jnp.maximum(jnp.linalg.norm(d2, axis=-1, keepdims=True), 1e-12)
    t2 = jnp.where(hit, jnp.inf, -1.0)
    light = -jnp.asarray([-0.4, -1.0, 0.5])
    d3 = jnp.broadcast_to(light / jnp.linalg.norm(light), (n, 3))
    o3 = si.p + si.n * (eps * jnp.sign(si.n @ d3[0]))[:, None]
    return [("camera", o, d, t_inf, False), ("bounce", o2, d2, t2, False),
            ("camera_any", o, d, t_inf, True),
            ("shadow_any", o3, d3, t2, True)]


def _time(fn, *args, reps=3):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return out, best


def compare_traversal(scene, camera, res):
    """Kernel (traversal op, CUDA branch on a GPU) against octree_traverse
    on the same device for each wavefront."""
    import jax
    import jax.numpy as jnp
    from computational_ray_tracer_tpu.ops import octree as octmod
    from computational_ray_tracer_tpu.ops import traversal

    tree, mesh = scene.octree, scene.mesh
    closest = jax.jit(lambda o, d, t: traversal.closest_hit(o, d, t, tree,
                                                            mesh))
    anyhit = jax.jit(lambda o, d, t: traversal.any_hit(o, d, t, tree, mesh))
    ref = jax.jit(lambda o, d, t: octmod.octree_traverse(o, d, t, tree,
                                                         mesh))
    out = {}
    for name, o, d, t_max, is_any in _wavefronts(scene, camera, res):
        r, t_ref = _time(ref, o, d, t_max, reps=1)
        if is_any:
            k, t_k = _time(anyhit, o, d, t_max)
            ref_hit = np.asarray(jnp.isfinite(r[0]) & (r[1] >= 0))
            agree = float(np.mean(np.asarray(k) == ref_hit))
            out[name] = {"agree": agree, "hits": int(ref_hit.sum()),
                         "kernel_s": t_k, "jnp_s": t_ref}
            _check(agree >= ID_AGREE_MIN, f"{name}: any-hit agreement "
                                          f"{agree}")
            continue
        k, t_k = _time(closest, o, d, t_max)
        ids_k, ids_r = np.asarray(k[1]), np.asarray(r[1])
        same = ids_k == ids_r
        agree = float(same.mean())
        hit = same & (ids_r >= 0)
        tk, tr = np.asarray(k[0])[hit], np.asarray(r[0])[hit]
        t_rel = float(np.max(np.abs(tk - tr) / np.abs(tr))) if hit.any() \
            else 0.0
        tests_k = float(np.asarray(k[4]).mean())
        out[name] = {"agree": agree, "hits": int((ids_r >= 0).sum()),
                     "max_t_rel": t_rel, "kernel_s": t_k, "jnp_s": t_ref,
                     "tests_per_ray_kernel": tests_k,
                     "tests_per_ray_jnp": float(np.asarray(r[4]).mean())}
        _check(agree >= ID_AGREE_MIN, f"{name}: id agreement {agree}")
        _check(t_rel <= T_REL_TOL, f"{name}: t differs by {t_rel}")
    return out


def phase_traversal():
    import bench
    scene = bench.dragon_scene(7, bench.MESH_CAP)
    out = {"mesh327k": compare_traversal(scene, bench.dragon_camera(512),
                                         512)}
    scene870, camera870 = bench.mesh870_setup(512)
    out["mesh872k"] = compare_traversal(scene870, camera870, 512)
    return out


def phase_render():
    import bench
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    import canonical

    out = {}
    dragon = bench.dragon_scene(7, bench.MESH_CAP)
    scene, camera, cfg = bench.flagship_setup(dragon, 512, 4)
    film, sensor, cold, warm = _timed_render(scene, camera, cfg, passes=4)
    out["flagship"] = {"cold_s": cold, "warm_s_per_pass": warm,
                       "img_mean": _check_mean("flagship",
                                               film.resolve(sensor))}

    scene, camera = bench.mesh870_setup(512)
    film, sensor, cold, warm = _timed_render(
        scene, camera, bench.direct_cfg(512, 4), passes=4, chunk=4)
    out["mesh870"] = {"cold_s": cold, "warm_s_per_pass": warm,
                      "img_mean": _check_mean("mesh870",
                                              film.resolve(sensor))}

    img, stats = canonical.render(500, 4)
    gate = canonical.check_golden(canonical.render(64, 4)[0])
    _check(gate["ok"], f"canonical golden gate failed: {gate}")
    out["canonical"] = {"sec_per_sample_pass": stats["sec_per_sample_pass"],
                        "compile_s": stats["compile_sec"],
                        "img_mean": _check_mean("canonical", img),
                        "golden_gate": gate}

    film, sensor, cold, warm = _timed_render(
        dragon, bench.dragon_camera(512), bench.deep512_cfg(), passes=2)
    out["deep512"] = {"cold_s": cold, "warm_s_per_pass": warm,
                      "img_mean": _check_mean("deep512",
                                              film.resolve(sensor))}
    return out


def phase_grad():
    import bench
    res = bench.grad_check(GRAD_REL_TOL)
    _check(res["ok"], f"gradient GPU vs CPU differs: {res}")
    return res


def phase_kernel_present():
    """The compiled flagship pass must call the CUDA traversal."""
    import jax
    import jax.numpy as jnp
    import bench
    from computational_ray_tracer_tpu.models import integrator as integ
    from computational_ray_tracer_tpu.ops import traversal

    scene, camera, cfg = bench.flagship_setup(
        bench.dragon_scene(7, bench.MESH_CAP), 512, 4)
    filter_obj = integ.make_filter(cfg)
    sensor = integ.make_sensor(cfg)
    compiled = jax.jit(lambda s, i: integ.render_pass(
        s, camera, cfg, filter_obj, sensor, i)).lower(
        scene, jnp.uint32(0)).compile()
    mem = compiled.memory_analysis()
    print("flagship pass memory_analysis:", mem, flush=True)
    n = compiled.as_text().count(traversal.FFI_TARGET)
    _check(n > 0, f"{traversal.FFI_TARGET} missing from the compiled pass")
    return {"custom_calls": n,
            "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
            "argument_bytes": getattr(mem, "argument_size_in_bytes", None)}


def phase_four(res=512, train_res=128):
    """Flagship (res^2) sharded over a (dp=4, sp=1) mesh against card 0, and
    one sharded train step's gradient (train_res^2) against the unsharded
    one."""
    import jax
    import jax.numpy as jnp
    import optax
    import bench
    from computational_ray_tracer_tpu.models import integrator as integ
    from computational_ray_tracer_tpu.models import inverse as inv
    from computational_ray_tracer_tpu.parallel import sharding as par

    devs = jax.devices()
    _check(len(devs) == 4, f"--four needs 4 GPUs, found {len(devs)}")
    mesh = par.make_mesh(n_dp=4, n_sp=1, devices=devs)
    dragon = bench.dragon_scene(7, bench.MESH_CAP)
    scene, camera, cfg = bench.flagship_setup(dragon, res, 4)
    cfg = dataclasses.replace(cfg, compact=False)   # sharding has no compact
    t0 = time.perf_counter()
    film_sh, _ = par.render_distributed(scene, camera, cfg, mesh)
    jax.block_until_ready(film_sh.rgb_sum)
    t_sh = time.perf_counter() - t0
    t0 = time.perf_counter()
    film_1, _ = integ.render(scene, camera, cfg, chunk=cfg.sampler.spp)
    jax.block_until_ready(film_1.rgb_sum)
    t_1 = time.perf_counter() - t0
    diff = float(np.max(np.abs(np.asarray(film_sh.rgb_sum)
                               - np.asarray(film_1.rgb_sum))))
    wdiff = float(np.max(np.abs(np.asarray(film_sh.weight_sum)
                                - np.asarray(film_1.weight_sum))))
    _check(diff <= SHARDED_ATOL and wdiff <= SHARDED_ATOL,
           f"sharded image differs from card 0 by {diff} (weights {wdiff})")

    # One sharded train step (SGD, lr 1) against the unsharded gradient.
    gscene, gcamera, gcfg = bench.flagship_setup(dragon, train_res, 4)
    gcfg = dataclasses.replace(gcfg, compact=False, max_depth=2)
    extract, insert = inv.albedo_params(gscene)
    target = jnp.full((train_res, train_res, 3), 0.1)
    render_image, _ = inv.make_render_fn(gcamera, gcfg, spp=1)
    g_ref = jax.jit(jax.grad(lambda p: jnp.mean(
        (render_image(insert(gscene, p)) - target) ** 2)))(extract(gscene))
    # both sides render sample 0 of the same (spp 4) stratification
    step, opt_init, _ = par.make_train_step(
        gscene, gcamera, gcfg, mesh, (extract, insert),
        optimizer=optax.sgd(1.0))
    params = extract(gscene)
    p_new, _, loss = step(params, opt_init(params), gscene, target, 0)
    g_sh = jax.tree_util.tree_map(lambda a, b: a - b, params, p_new)
    a = np.asarray(g_sh["albedo_coeffs"])
    b = np.asarray(g_ref["albedo_coeffs"])
    g_rel = float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))
    _check(g_rel < GRAD_REL_TOL, f"sharded gradient differs by {g_rel}")
    return {"mesh": dict(mesh.shape), "max_abs_diff_rgb": diff,
            "max_abs_diff_weight": wdiff, "sharded_render_s": t_sh,
            "single_render_s": t_1, "train_loss": float(loss),
            "grad_max_rel_diff": g_rel}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded phase")
    args = ap.parse_args(argv)

    phases = Phases()
    if not args.four:
        phases.run("gpu_tests", phase_gpu_tests)
    ok, device = phases.run("device", phase_device)
    if not ok:
        return 1
    if args.four:
        phases.run("four", phase_four)
    else:
        for name, fn in (("cornell", phase_cornell),
                         ("traversal", phase_traversal),
                         ("render", phase_render),
                         ("grad", phase_grad),
                         ("kernel_present", phase_kernel_present)):
            phases.run(name, fn)
    if phases.failed:
        print(f"failed phases: {phases.failed}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
