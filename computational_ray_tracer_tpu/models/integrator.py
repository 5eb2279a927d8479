"""Wavefront integrators: random walk, simple path (NEE), direct lighting.

This is the layer the reference only *sketched* (``RayTracer/Integrator.h:
4-12`` names RandomWalk/SimplePath/Path as intent; the only implemented
estimator is the inline direct-lighting ``Li`` lambda of
``RayTracerTestApp.h:218-284``). Wavefront design (SURVEY §7 stance #1):

- rays live as SoA wavefronts ``(N, 3)``; one ``lax.scan`` over bounce depth
  replaces recursion; alive masks replace early returns;
- every random decision is a pure function of ``(seed, pixel, sample, dim)``
  via the counter-based samplers (placement-invariant determinism, §3.4);
- radiance/throughput carry the 8-wavelength hero axis;
- sampling decisions are detached (`stop_gradient`) while radiance stays
  differentiable w.r.t. scene parameters — reparameterized gradients.

The per-sample pipeline (``evaluate_pixel``, RayTracerTestApp.h:287-345) is
``render_pass``: λ sample → filter-importance pixel offset → camera ray →
Li → sensor RGB → weighted film accumulation, for every pixel at once.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from computational_ray_tracer_tpu.ops import rng
from computational_ray_tracer_tpu.ops import spectrum as spec
from computational_ray_tracer_tpu.ops import filters as flt
from computational_ray_tracer_tpu.ops import sensor as sen
from computational_ray_tracer_tpu.ops import film as filmmod
from computational_ray_tracer_tpu.models import materials as mat
from computational_ray_tracer_tpu.models import lights as lgt
from computational_ray_tracer_tpu.models.scene import (scene_intersect,
                                                       scene_occluded,
                                                       texture_lookup)

# Sample-dimension allocation per (pixel, sample): mirrors the dimension
# ordering discipline of evaluate_pixel (λ, filter, lens, then per-bounce).
DIM_LAMBDA = 0
DIM_FILTER = 1      # 2D
DIM_LENS = 3        # 2D
DIM_BOUNCE0 = 5
DIMS_PER_BOUNCE = 8  # bsdf 2D + bsdf 1D + light select + light pos 2D + rr


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Which pixel sampler supplies the u's (samplers.h tiers).

    ``sobol_global`` is the SobolIntervalToIndex tier (samplers.h:144-327):
    one Owen-scrambled sequence over the whole image; needs ``width``/``m``
    (auto-filled from RenderConfig.resolution)."""
    kind: str = "independent"   # independent | stratified | sobol | sobol_global
    spp: int = 16
    xs: int = 4                 # stratified grid (xs*ys == spp)
    ys: int = 4
    seed: int = 0
    jitter: bool = True
    width: int = 0              # image width (sobol_global pixel decode)
    m: int = 0                  # log2 image scale (sobol_global)

    def _pxpy(self, pixel):
        w = jnp.uint32(self.width)
        return pixel % w, pixel // w

    def get_1d(self, pixel, sample_idx, dim):
        if self.kind == "stratified":
            return rng.stratified_1d(self.seed, pixel, sample_idx, dim,
                                     self.spp, self.jitter)
        if self.kind == "sobol":
            return rng.sobol_owen_1d(self.seed, pixel, sample_idx, dim,
                                     spp=self.spp)
        if self.kind == "sobol_global":
            px, py = self._pxpy(pixel)
            return rng.sobol_global_1d(self.seed, px, py, sample_idx, dim,
                                       self.m)
        return rng.independent_1d(self.seed, pixel, sample_idx, dim)

    def get_2d(self, pixel, sample_idx, dim):
        if self.kind == "stratified":
            return rng.stratified_2d(self.seed, pixel, sample_idx, dim,
                                     self.xs, self.ys, self.jitter)
        if self.kind == "sobol":
            return rng.sobol_owen_2d(self.seed, pixel, sample_idx, dim,
                                     spp=self.spp)
        if self.kind == "sobol_global":
            px, py = self._pxpy(pixel)
            if isinstance(dim, int) and dim == DIM_FILTER:
                # in-pixel position from sequence dims 0/1 (GetPixel2D)
                return rng.sobol_global_pixel2d(self.seed, px, py,
                                                sample_idx, self.m)
            return rng.sobol_global_2d(self.seed, px, py, sample_idx, dim,
                                       self.m)
        return rng.independent_2d(self.seed, pixel, sample_idx, dim)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    resolution: tuple = (256, 256)          # (W, H)
    sampler: SamplerConfig = SamplerConfig()
    integrator: str = "path"                # path(MIS) | simple | direct | walk
    max_depth: int = 5
    rr_start: int = 3                       # Russian roulette from this depth
    lambda_mode: str = "visible"            # visible | uniform
    filter_name: str = "gaussian"
    filter_radius: tuple = (0.5, 0.5)
    sensor_name: Any = None                 # None = XYZ sensor
    clamp: float = 0.0                      # 0 = no firefly clamp
    ray_eps: float = 1e-3                   # legacy absolute offset floor
    # Scale-relative spawn offset: eps = ray_eps_scale * (|p| + t). Replaces
    # the reference's per-hit conservative FP error bounds
    # (Shapes.h:1226-1256) with a conservative relative bound that renders
    # unit-scale and 1000x-scale scenes identically.
    ray_eps_scale: float = 3e-5
    # Wavefront compaction (SURVEY §7 stance #1, second half): gather alive
    # rays into a dense direction-sorted bucket between bounces so deep
    # bounces pay for surviving rays only (the reference's dead pixels cost
    # nothing, RayTracerTestApp.h:361-366). Changes NO sample value — every
    # sample is keyed by (pixel, sample, dim). Honored by render() (each
    # pass goes through render_pass_compact); render_pass/render_passes are
    # the raw full-wavefront pieces and ignore it.
    compact: bool = False
    compact_quantum: int = 1024             # bucket rounding (packet tile)

    def __post_init__(self):
        # sobol_global needs the image geometry; derive it once here.
        s = self.sampler
        if s.kind == "sobol_global" and s.width == 0:
            w, h = self.resolution
            m = max(int(np.ceil(np.log2(max(w, h, 1)))), 0)
            assert s.spp <= 1 << max(32 - 2 * m, 0), \
                "sobol_global: spp * 4^m must fit in 32 bits"
            object.__setattr__(self, "sampler",
                               dataclasses.replace(s, width=w, m=m))


def spawn_eps(si, cfg: RenderConfig):
    """Per-hit self-intersection offset: relative to the magnitudes that
    entered the hit-point computation (|p| and the ray parameter t), so it
    tracks the actual f32 rounding error at any scene scale."""
    mag = jnp.max(jnp.abs(si.p), axis=-1) + jnp.abs(
        jnp.where(jnp.isfinite(si.t), si.t, 0.0))
    return cfg.ray_eps_scale * jnp.maximum(mag, 1e-3)


def _sample_wavelengths(cfg, u):
    if cfg.lambda_mode == "uniform":
        return spec.sample_uniform_wavelengths(u)
    return spec.sample_visible_wavelengths(u)


def _tex_coeffs(scene, si):
    if scene.texture is None:
        return None
    return texture_lookup(scene.texture, si.uv)


# ---------------------------------------------------------------------------
# Radiance estimators
# ---------------------------------------------------------------------------

def li_direct(scene, o, d, wl, pixel, sample_idx, cfg):
    """Single-bounce direct lighting — the reference's implemented Li
    (RayTracerTestApp.h:218-284): hit → emission + Σ_sampled-light
    f·Li·cos/pdf with a shadow ray."""
    t_max = jnp.full(o.shape[:-1], jnp.inf)
    si, mid, _ = scene_intersect(scene, o, d, t_max)
    mrow = mat.MaterialView.create(scene.materials, mid)
    # Per-pass spectral cache (one interp of all dense tables; see
    # _spectral_cache) — the per-site interps were fusion barriers.
    # Size-guarded like the path loop: many-material scenes fall back to
    # per-site interpolation instead of the unrolled where-chain.
    use_cache = _use_spectral_cache(scene)
    n_l = scene.lights.n_lights
    n_m = scene.materials.kind.shape[0]
    if use_cache:
        svals = _spectral_cache(scene, wl.lam)
        light_vals = svals[..., :n_l]
        emit = _cache_select(svals[..., n_l:n_l + n_m], mid)
    else:
        light_vals = None
        emit, _, _ = mat.material_spectra(mrow, wl.lam)
    # Emission is one-sided (front face only), matching the quad-light
    # convention in models/lights.py — see the note in _bounce_step.
    L = jnp.where((si.valid & ~si.backface)[..., None], emit, 0.0)

    s = cfg.sampler
    u_sel = s.get_1d(pixel, sample_idx, DIM_BOUNCE0)
    u_pos = s.get_2d(pixel, sample_idx, DIM_BOUNCE0 + 1)
    wr = scene.world_radius()
    wi, dist, li_val, pdf, _ = lgt.sample_light(scene.lights, si.p, si.n,
                                                wl.lam, u_sel, u_pos, wr,
                                                spd_vals=light_vals)
    f, _ = mat.bsdf_eval(mrow, si.n, si.wo, wi, wl.lam, _tex_coeffs(scene, si),
                         enable_rough=scene.has_rough)
    cos_i = jnp.maximum(jnp.sum(wi * si.n, axis=-1), 0.0)
    # Invalid pixels (camera ray missed) must carry DEAD shadow rays:
    # their placeholder surface point is the origin — typically INSIDE the
    # scene geometry — and an alive phantom ray from there would do a
    # worst-case traversal before being masked out of the image.
    dist = jnp.where(si.valid, dist, -1.0)
    occluded = scene_occluded(scene, si.p, wi, dist, spawn_eps(si, cfg),
                              n=si.n)
    contrib = f * li_val * (cos_i / jnp.maximum(pdf, 1e-12))[..., None]
    contrib = jnp.where((si.valid & ~occluded)[..., None], contrib, 0.0)
    return L + contrib


def _bounce_step(scene, cfg, mode, state, depth, pixel, sample_idx):
    """One bounce of the wavefront path loop, on whatever ray set ``state``
    holds (the full wavefront under lax.scan, or a compacted alive-only
    bucket under the host-driven loop). Every random decision inside is a
    pure function of (seed, pixel, sample_idx, dim(depth)) — the ray set
    membership cannot change any sample value (determinism contract).

    ``state`` carries per-ray: o, d, beta, L, alive, specular, pdf_prev,
    n_prev, lam (hero wavelengths), lam_pdf. Returns (new_state,
    n_alive_in)."""
    from computational_ray_tracer_tpu.ops.montecarlo import power_heuristic
    s = cfg.sampler
    use_nee = mode in ("simple", "mis")
    use_mis = mode == "mis"
    n_shape = state["alive"].shape
    S = state["lam"].shape[-1]

    if True:   # (keeps the historical indentation of the bounce body)
        o, d = state["o"], state["d"]
        alive = state["alive"]
        beta = state["beta"]
        L = state["L"]
        wl_cur = spec.SampledWavelengths(state["lam"], state["lam_pdf"])

        t_max = jnp.where(alive, jnp.inf, -1.0)
        si, mid, _ = scene_intersect(scene, o, d, t_max)
        hit = si.valid & alive
        mrow = mat.MaterialView.create(scene.materials, mid)
        tex = _tex_coeffs(scene, si)

        # Per-pass spectral cache (see _spectral_cache): all dense-table
        # values at this ray's hero wavelengths, interpolated once before
        # the loop. Row selects below replace per-bounce interpolation.
        svals = state.get("svals")
        if svals is not None:
            n_l = scene.lights.n_lights
            n_m = scene.materials.kind.shape[0]
            light_vals = svals[..., :n_l]
            emit_vals = svals[..., n_l:n_l + n_m]
            eta_vals = svals[..., n_l + n_m:n_l + 2 * n_m]
            k_vals = svals[..., n_l + 2 * n_m:n_l + 3 * n_m]
        else:
            light_vals = None

        # Escaped rays collect the environment (ambient lights). Same
        # single/double-count discipline as surface emission below.
        miss = alive & ~si.valid
        L_env, _ = lgt.env_radiance(scene.lights, wl_cur.lam,
                                    spd_vals=light_vals)
        if use_mis:
            pdf_amb = lgt.pdf_ambient_direction(scene.lights,
                                                state["n_prev"], d)
            w_env = jnp.where(
                state["specular"], 1.0,
                power_heuristic(1.0, state["pdf_prev"], 1.0, pdf_amb))
        elif mode == "walk":
            w_env = jnp.ones(n_shape)
        else:   # simple: NEE already sampled the ambient at the prev vertex
            w_env = jnp.where(state["specular"], 1.0, 0.0)
        L = L + jnp.where(miss[..., None],
                          beta * L_env * w_env[..., None], 0.0)

        # Emitted radiance. Camera/specular prefixes always count it. After
        # a diffuse bounce: walk counts it (only estimator), simple skips it
        # (NEE already did), mis counts it weighted against the light pdf.
        # One fused dense-table evaluation serves emission AND the eta/k the
        # BSDF sample needs below (shared interpolation weights).
        # Emission is ONE-SIDED (front face only): the quad-light NEE model
        # is one-sided (lights.py), and pdf_light_direction returns 0 for
        # back-side hits — so a back-face emission hit would be counted at
        # FULL MIS weight with no NEE counterpart, making path/walk
        # disagree with simple by the whole back-lobe (caught by the
        # equal-error harness: the ceiling above the Cornell light read
        # MSE 0.02 brighter under mis than simple).
        if svals is not None:
            emit = _cache_select(emit_vals, mid)
            eta_s = _cache_select(eta_vals, mid)
            k_s = _cache_select(k_vals, mid)
        else:
            emit, eta_s, k_s = mat.material_spectra(mrow, wl_cur.lam)
        emit = jnp.where(si.backface[..., None], 0.0, emit)
        if use_mis:
            pdf_l_hit = lgt.pdf_light_direction(scene.lights, o, d, si.t)
            w_emit = jnp.where(
                state["specular"], 1.0,
                power_heuristic(1.0, state["pdf_prev"], 1.0, pdf_l_hit))
            count_emit = hit
        else:
            w_emit = jnp.ones(n_shape)
            count_emit = hit & (state["specular"] | (mode == "walk"))
        L = L + jnp.where(count_emit[..., None],
                          beta * emit * w_emit[..., None], 0.0)

        dim0 = DIM_BOUNCE0 + depth * DIMS_PER_BOUNCE
        eps_h = spawn_eps(si, cfg)

        # --- next-event estimation
        if use_nee:
            u_sel = s.get_1d(pixel, sample_idx, dim0 + 3)
            u_pos = s.get_2d(pixel, sample_idx, dim0 + 4)
            wr = scene.world_radius()
            wi_l, dist, li_val, pdf_l, lkind = lgt.sample_light(
                scene.lights, si.p, si.n, wl_cur.lam, u_sel, u_pos, wr,
                spd_vals=light_vals)
            f, pdf_b = mat.bsdf_eval(mrow, si.n, si.wo, wi_l, wl_cur.lam, tex,
                                     eta_k=(eta_s, k_s),
                                     enable_rough=scene.has_rough)
            cos_l = jnp.maximum(jnp.sum(wi_l * si.n, axis=-1), 0.0)
            # Rays without a surface hit carry DEAD shadow rays (see
            # li_direct: phantom rays from the placeholder origin point
            # would do worst-case traversals before being masked out).
            occ = scene_occluded(scene, si.p, wi_l,
                                 jnp.where(hit, dist, -1.0), eps_h,
                                 n=si.n)
            nee = beta * f * li_val * (cos_l / jnp.maximum(pdf_l, 1e-12))[..., None]
            if use_mis:
                # Delta lights (point/distant) can't be BSDF-sampled: w=1.
                hittable = (lkind == lgt.AREA_QUAD) | (lkind == lgt.AMBIENT)
                w_l = jnp.where(hittable,
                                power_heuristic(1.0, pdf_l, 1.0, pdf_b), 1.0)
                nee = nee * w_l[..., None]
            L = L + jnp.where((hit & ~occ)[..., None], nee, 0.0)

        # --- BSDF sampling, continuation
        u2 = s.get_2d(pixel, sample_idx, dim0)
        u1 = s.get_1d(pixel, sample_idx, dim0 + 2)
        wi, w_bsdf, pdf_bsdf, is_spec, term_2nd = mat.bsdf_sample(
            mrow, si.n, si.wo, jax.lax.stop_gradient(u2),
            jax.lax.stop_gradient(u1), wl_cur.lam, tex_rgb_coeffs=tex,
            eta_k=(eta_s, k_s), backface=si.backface,
            enable_rough=scene.has_rough)
        beta_new = beta * w_bsdf
        # Dispersion: collapse secondary wavelengths at dielectric bounces
        lam_pdf = state["lam_pdf"]
        collapse = hit & term_2nd & ~wl_cur.secondary_terminated()
        new_pdf = jnp.concatenate([lam_pdf[..., :1] / S,
                                   jnp.zeros_like(lam_pdf[..., 1:])], axis=-1)
        lam_pdf = jnp.where(collapse[..., None], new_pdf, lam_pdf)
        beta_new = jnp.where(
            collapse[..., None],
            jnp.concatenate([beta_new[..., :1],
                             jnp.zeros_like(beta_new[..., 1:])], axis=-1),
            beta_new)

        # --- Russian roulette (detached)
        max_beta = jnp.max(jax.lax.stop_gradient(beta_new), axis=-1)
        u_rr = s.get_1d(pixel, sample_idx, dim0 + 6)
        q = jnp.clip(max_beta, 0.05, 1.0)
        do_rr = depth >= cfg.rr_start
        survive = jnp.where(do_rr, u_rr < q, True)
        beta_new = jnp.where(do_rr, beta_new / q[..., None], beta_new)

        alive_new = hit & survive & (max_beta > 0.0)
        # spawn along the normal, signed toward wi's hemisphere (handles
        # transmission), with the scale-relative offset
        side = jnp.sign(jnp.sum(wi * si.n, axis=-1))
        o_new = si.p + si.n * (side * eps_h)[..., None]
        new_state = dict(
            o=jnp.where(hit[..., None], o_new, o),
            d=jnp.where(hit[..., None], wi, d),
            beta=jnp.where(alive_new[..., None], beta_new, 0.0),
            L=L,
            alive=alive_new,
            specular=jnp.where(hit, is_spec, state["specular"]),
            pdf_prev=jnp.where(hit, pdf_bsdf, state["pdf_prev"]),
            n_prev=jnp.where(hit[..., None], si.n, state["n_prev"]),
            lam=state["lam"],
            lam_pdf=lam_pdf)
        if svals is not None:
            new_state["svals"] = svals     # per-pass constant, rides along
        return new_state, jnp.sum(alive.astype(jnp.float32))


# Spectral-cache column budget. Beyond this, _cache_select's unrolled
# where-chain per material/light per bounce inflates the traced graph and
# the (N, S, C) carry inflates device memory; fall back to per-site
# interpolation.
SPECTRAL_CACHE_MAX_COLS = 32


def _use_spectral_cache(scene):
    n_l = scene.lights.n_lights
    n_m = scene.materials.kind.shape[0]
    return (n_l + 3 * n_m) <= SPECTRAL_CACHE_MAX_COLS


def _spectral_cache(scene, lam):
    """Per-ray evaluation of EVERY dense spectral table at the hero
    wavelengths, in one interpolation: (..., S, L + 3M) ordered
    [lights.spd | materials.emission | materials.eta | materials.k].

    The wavelengths are fixed for a path's whole bounce loop, so the
    interpolation indices and weights depend only on them. Evaluating the
    stacked tables once per pass and selecting rows per bounce removes ~3
    interpolation sites x max_depth from the loop. The values equal the
    per-bounce sample_dense_rows calls they replace."""
    stack = jnp.concatenate([scene.lights.spd, scene.materials.emission,
                             scene.materials.eta, scene.materials.k], axis=0)
    return spec.sample_dense_multi(stack.T, lam)     # (..., S, C)


def _cache_select(vals, idx):
    """Static-size where-chain row select over the trailing axis:
    vals (..., S, M), idx (...) -> (..., S). Out-of-range idx clamps to
    row 0 (callers mask)."""
    out = vals[..., 0]
    for k in range(1, vals.shape[-1]):
        out = jnp.where((idx == k)[..., None], vals[..., k], out)
    return out


def _init_path_state(o, d, wl, scene=None):
    n_shape = o.shape[:-1]
    S = wl.lam.shape[-1]
    state = dict(
        o=o, d=d,
        beta=jnp.ones(n_shape + (S,)),
        L=jnp.zeros(n_shape + (S,)),
        alive=jnp.ones(n_shape, bool),
        specular=jnp.ones(n_shape, bool),   # last bounce was camera/specular
        pdf_prev=jnp.ones(n_shape),         # solid-angle pdf of last bounce
        n_prev=jnp.zeros(n_shape + (3,)),   # shading normal at last vertex
        lam=wl.lam,
        lam_pdf=wl.pdf,
    )
    if scene is not None and _use_spectral_cache(scene):
        state["svals"] = _spectral_cache(scene, wl.lam)
    return state


def _path_scan(scene, o, d, wl, pixel, sample_idx, cfg, mode):
    """Shared wavefront loop for the three multi-bounce estimators
    (Integrator.h:4-12 intent):

    - ``walk``: RandomWalk — BSDF sampling only, lights found by hitting;
    - ``simple``: SimplePath — NEE at every diffuse vertex, BSDF-found
      emission counted only on camera/specular prefixes;
    - ``mis``: Path — NEE *and* BSDF-sampled emission, both weighted by the
      power heuristic (montecarlo.balance/power_heuristic) so glossy +
      small-light scenes converge where either strategy alone is poor.
    """
    init = _init_path_state(o, d, wl, scene=scene)

    def bounce(state, depth):
        return _bounce_step(scene, cfg, mode, state, depth, pixel,
                            sample_idx)

    # One lax.scan over bounce depth (SURVEY §7 stance #1): the body is
    # traced ONCE regardless of max_depth, keeping the HLO small and
    # compile times flat as depth grows. depth is a traced scalar; all
    # sample-dimension arithmetic and the RR gate are data arithmetic.
    state, alive_counts = jax.lax.scan(
        bounce, init, jnp.arange(cfg.max_depth, dtype=jnp.uint32))
    wl_out = spec.SampledWavelengths(wl.lam, state["lam_pdf"])
    return state["L"], wl_out, alive_counts


def alive_fractions(scene, camera, cfg: RenderConfig, sample_idx=0):
    """Per-depth alive-ray fractions of one wavefront pass — honest rays/s
    accounting alongside the nominal count (dead rays ride the lockstep
    bounce scan as masked work)."""
    w, h = cfg.resolution
    s = cfg.sampler
    pixel = jnp.arange(w * h, dtype=jnp.uint32)
    px = (pixel % w).astype(jnp.float32)
    py = (pixel // w).astype(jnp.float32)
    u_lam = s.get_1d(pixel, jnp.uint32(sample_idx), DIM_LAMBDA)
    wl = _sample_wavelengths(cfg, u_lam)
    o, d = camera.generate_rays(
        jnp.stack([px + 0.5, py + 0.5], axis=-1),
        s.get_2d(pixel, jnp.uint32(sample_idx), DIM_LENS))
    mode = {"walk": "walk", "simple": "simple"}.get(cfg.integrator, "mis")
    _, _, counts = _path_scan(scene, o, d, wl, pixel,
                              jnp.uint32(sample_idx), cfg, mode)
    return counts / (w * h)


def li_path(scene, o, d, wl, pixel, sample_idx, cfg):
    """Path: MIS combination of NEE and BSDF-sampled emission with the
    power heuristic, RR termination (the Integrator.h "Path" intent)."""
    L, wl_out, _ = _path_scan(scene, o, d, wl, pixel, sample_idx, cfg,
                              mode="mis")
    return L, wl_out


def li_simple_path(scene, o, d, wl, pixel, sample_idx, cfg):
    """SimplePath: NEE at every diffuse vertex, emission counted on
    specular/camera prefixes only."""
    L, wl_out, _ = _path_scan(scene, o, d, wl, pixel, sample_idx, cfg,
                              mode="simple")
    return L, wl_out


def li_random_walk(scene, o, d, wl, pixel, sample_idx, cfg):
    """RandomWalk: BSDF sampling only, lights found by hitting them."""
    L, wl_out, _ = _path_scan(scene, o, d, wl, pixel, sample_idx, cfg,
                              mode="walk")
    return L, wl_out


# ---------------------------------------------------------------------------
# The per-sample pixel pipeline + progressive render driver
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnums=(0, 1, 2))
def _tile_perm(w, h, tile=32):
    """Pixel order that walks the image in tile×tile screen blocks.

    Neighbouring rays in a tile take neighbouring paths through the octree,
    so consecutive threads of the traversal read the same nodes. Returns
    (perm, inv): ray i handles pixel perm[i]; per-ray output row inv[p]
    belongs to pixel p. Sample values are keyed by pixel id so the swizzle
    changes no rendered value (determinism contract), only wavefront
    order."""
    ids = jnp.arange(w * h, dtype=jnp.uint32).reshape(h, w)
    blocks = ids.reshape(h // tile, tile, w // tile, tile)
    perm = blocks.transpose(0, 2, 1, 3).reshape(-1)
    inv = jnp.zeros((w * h,), jnp.int32).at[perm].set(
        jnp.arange(w * h, dtype=jnp.int32))
    return perm, inv


def _swizzled_pixels(w, h, tile=32):
    if w % tile or h % tile or w * h < tile * tile:
        return jnp.arange(w * h, dtype=jnp.uint32), None
    return _tile_perm(w, h, tile)


@functools.lru_cache(maxsize=64)
def make_filter(cfg: RenderConfig):
    # Memoized per (frozen) config: repeated render() calls must hand the
    # SAME filter instance to the compact pipeline, whose program cache is
    # keyed by object identity — fresh instances per call retraced the
    # whole bounce pipeline every pass (measured 13 s vs 0.7 s per
    # depth-8 512^2 pass on a resume-style per-pass render() loop).
    return flt.FILTERS[cfg.filter_name](cfg.filter_radius)


@functools.lru_cache(maxsize=64)
def make_sensor(cfg: RenderConfig):
    return sen.PixelSensor.create(cfg.sensor_name)


def render_pass(scene, camera, cfg: RenderConfig, filter_obj, sensor,
                sample_idx):
    """One sample-per-pixel wavefront pass. Returns (rgb (H,W,3),
    weight (H,W)) — ready for Film.add_aligned."""
    w, h = cfg.resolution
    s = cfg.sampler
    pixel, inv = _swizzled_pixels(w, h)
    px = (pixel % w).astype(jnp.float32)
    py = (pixel // w).astype(jnp.float32)

    u_lam = s.get_1d(pixel, sample_idx, DIM_LAMBDA)
    wl = _sample_wavelengths(cfg, u_lam)

    u_filt = s.get_2d(pixel, sample_idx, DIM_FILTER)
    fp, fw = filter_obj.sample(u_filt)
    pixel_pos = jnp.stack([px + 0.5, py + 0.5], axis=-1) + fp

    u_lens = s.get_2d(pixel, sample_idx, DIM_LENS)
    o, d = camera.generate_rays(pixel_pos, u_lens)

    if cfg.integrator == "direct":
        L = li_direct(scene, o, d, wl, pixel, sample_idx, cfg)
        wl_out = wl
    elif cfg.integrator == "walk":
        L, wl_out = li_random_walk(scene, o, d, wl, pixel, sample_idx, cfg)
    elif cfg.integrator == "simple":
        L, wl_out = li_simple_path(scene, o, d, wl, pixel, sample_idx, cfg)
    else:
        L, wl_out = li_path(scene, o, d, wl, pixel, sample_idx, cfg)

    rgb = sensor.to_sensor_rgb(L, wl_out)
    if cfg.clamp > 0.0:
        rgb = jnp.clip(rgb, 0.0, cfg.clamp)
    else:
        rgb = jnp.maximum(rgb, 0.0)
    if inv is not None:
        rgb = rgb[inv]
        fw = fw[inv]
    return rgb.reshape(h, w, 3), fw.reshape(h, w)


# ---------------------------------------------------------------------------
# Compacted wavefront renderer (host-driven bounce loop)
# ---------------------------------------------------------------------------

_COMPACT_CACHE = {}
# Identity-keyed program caches are FIFO-bounded: every entry pins its
# camera/filter/sensor AND compiled XLA executables, so an unbounded dict
# leaks monotonically in camera-sweep / per-frame-camera workloads (and
# an id-keyed cache can never hit for fresh objects anyway).
_CACHE_MAX_ENTRIES = 64


def _cache_put(cache, key, value):
    if len(cache) >= _CACHE_MAX_ENTRIES:
        cache.pop(next(iter(cache)))
    cache[key] = value


def _compact_fns(cfg: RenderConfig, mode: str, camera, filter_obj, sensor):
    """Jitted pieces of the compacted bounce loop, cached per
    (config, camera/filter/sensor identity). Camera, filter and sensor are
    closure captures exactly as in render_pass (they are not pytrees).

    Jitted pieces of the compacted bounce loop, cached per config.

    XLA needs static shapes, so "process only alive rays" becomes: sort
    rays alive-first (sub-ordered by direction octant and origin cell, so
    neighbouring rays traverse alike), take the smallest quantized bucket
    that covers the exact alive count, bounce that bucket, scatter back.
    The alive count is read back to the host once per bounce — the only
    sync — to pick the bucket size; each distinct bucket size compiles
    once and is reused across passes."""
    # id()-keyed caches must pin their keyed objects: a GC'd camera's id
    # can be recycled by a DIFFERENT camera, aliasing the entry (the
    # cached programs have the old camera's parameters baked in). The
    # strong reference stored with the entry makes id reuse impossible
    # while the entry lives.
    key = (cfg, mode, id(camera), id(filter_obj), id(sensor))
    if key in _COMPACT_CACHE:
        return _COMPACT_CACHE[key][0]

    @jax.jit
    def prologue(scene, sample_idx):
        w, h = cfg.resolution
        s = cfg.sampler
        pixel, inv = _swizzled_pixels(w, h)
        px = (pixel % w).astype(jnp.float32)
        py = (pixel // w).astype(jnp.float32)
        u_lam = s.get_1d(pixel, sample_idx, DIM_LAMBDA)
        wl = _sample_wavelengths(cfg, u_lam)
        u_filt = s.get_2d(pixel, sample_idx, DIM_FILTER)
        fp, fw = filter_obj.sample(u_filt)
        pixel_pos = jnp.stack([px + 0.5, py + 0.5], axis=-1) + fp
        u_lens = s.get_2d(pixel, sample_idx, DIM_LENS)
        o, d = camera.generate_rays(pixel_pos, u_lens)
        return _init_path_state(o, d, wl, scene=scene), pixel, fw

    @jax.jit
    def count_alive(alive):
        return jnp.sum(alive.astype(jnp.int32))

    @jax.jit
    def select_order(alive, d, o):
        # Alive rays sort by (direction octant, 8^3 Morton cell of the
        # origin), dead rays last (scene._packet_order). Compiled ONCE on
        # the full wavefront (the radix sort, see scene.radix_order); the
        # caller slices the first `bucket` entries outside jit, so no
        # per-bucket recompile of the sort.
        from computational_ray_tracer_tpu.models.scene import _packet_order
        return _packet_order(o, d, alive)

    def select(alive, d, o, bucket):
        return select_order(alive, d, o)[:bucket]

    @jax.jit
    def gather(state, pixel, idx):
        sub = jax.tree_util.tree_map(lambda a: a[idx], state)
        return sub, pixel[idx]

    @jax.jit
    def bounce_sub(scene, sub, depth, pixel_sub, sample_idx):
        # one program per bucket size
        new, _ = _bounce_step(scene, cfg, mode, sub, depth, pixel_sub,
                              sample_idx)
        return new

    @jax.jit
    def scatter(state, sub_new, idx):
        return {k: state[k].at[idx].set(sub_new[k]) for k in state}

    @jax.jit
    def epilogue(state, fw, pixel_cur):
        # State rows may be a PERMUTATION of the launch order (full-bucket
        # depths permute in place instead of scattering back); pixel_cur
        # names each row's pixel, so the film is assembled by pixel-id
        # scatter. fw rows are still in prologue (swizzle) order.
        w, h = cfg.resolution
        wl_out = spec.SampledWavelengths(state["lam"], state["lam_pdf"])
        rgb = sensor.to_sensor_rgb(state["L"], wl_out)
        if cfg.clamp > 0.0:
            rgb = jnp.clip(rgb, 0.0, cfg.clamp)
        else:
            rgb = jnp.maximum(rgb, 0.0)
        pixel0, _ = _swizzled_pixels(w, h)
        rgb_flat = jnp.zeros((w * h, 3)).at[pixel_cur].set(rgb)
        fw_flat = jnp.zeros((w * h,)).at[pixel0].set(fw)
        return rgb_flat.reshape(h, w, 3), fw_flat.reshape(h, w)

    fns = (prologue, count_alive, select, gather, bounce_sub, scatter,
           epilogue)
    _cache_put(_COMPACT_CACHE, key, (fns, (camera, filter_obj, sensor)))
    return fns


# Per-(cfg, camera) alive-count schedules from completed compacted passes:
# later passes predict bucket sizes from the last pass instead of paying a
# device->host count readback per bounce (each one a host sync that drains
# the device queue).
_BUCKET_SCHEDULE = {}


def render_pass_compact(scene, camera, cfg: RenderConfig, filter_obj,
                        sensor, sample_idx):
    """One spp pass with between-bounce wavefront compaction. Sample
    values are identical to render_pass (asserted by tests); only the set
    of rays carried through each bounce shrinks.

    Host-driven with PREDICTED buckets: the first pass reads the alive
    count back per bounce (exact path) and records the schedule;
    subsequent passes size each bucket from the recorded counts (with
    headroom), verify on-device that every actual count fit its bucket,
    and read ONE flag back at the end — if any bucket overflowed (alive
    set grew vs the schedule), the pass is redone on the exact path, so
    results are always identical to the exact path."""
    assert cfg.integrator != "direct", "compaction needs a multi-bounce mode"
    mode = {"walk": "walk", "simple": "simple"}.get(cfg.integrator, "mis")
    fns = _compact_fns(cfg, mode, camera, filter_obj, sensor)
    (prologue, count_alive, select, gather, bounce_sub, scatter,
     epilogue) = fns

    sched_key = (cfg, mode, id(camera))
    entry = _BUCKET_SCHEDULE.get(sched_key)
    if entry is not None:
        out = _compact_pass_predicted(scene, cfg, fns, entry[1], sample_idx)
        if out is not None:
            return out
        # overflow: fall through to the exact path (and re-record)
    return _compact_pass_exact(scene, cfg, fns, sched_key, sample_idx,
                               camera)


def _compact_pass_exact(scene, cfg, fns, sched_key, sample_idx, camera):
    (prologue, count_alive, select, gather, bounce_sub, scatter,
     epilogue) = fns
    w, h = cfg.resolution
    n = w * h
    q = cfg.compact_quantum
    state, pixel, fw = prologue(scene, jnp.uint32(sample_idx))
    counts = []
    for depth in range(cfg.max_depth):
        k = int(count_alive(state["alive"]))            # host sync
        counts.append(k)
        if k == 0:
            break
        # Buckets above n/2 round UP to the full wavefront: an in-place
        # sort (permute state + pixel, no scatter-back) reuses the
        # full-size bounce program instead of compiling a fresh odd-size
        # program per pass.
        bucket = n if k > n // 2 else min(n, -(-k // q) * q)
        if depth == 0 and bucket >= n:
            # Camera wavefront: the tile-swizzled launch order IS the
            # coherent order. The (octant, Morton-of-origin) resort keys
            # on the random LENS position for a thin-lens camera and
            # would shuffle tiles into noise.
            state = bounce_sub(scene, state, jnp.uint32(depth), pixel,
                               jnp.uint32(sample_idx))
            continue
        idx = select(state["alive"], state["d"], state["o"], bucket)
        if bucket >= n:
            state, pixel = gather(state, pixel, idx)
            state = bounce_sub(scene, state, jnp.uint32(depth), pixel,
                               jnp.uint32(sample_idx))
        else:
            sub, pixel_sub = gather(state, pixel, idx)
            sub_new = bounce_sub(scene, sub, jnp.uint32(depth), pixel_sub,
                                 jnp.uint32(sample_idx))
            state = scatter(state, sub_new, idx)
    # the strong camera ref pins the id()-keyed entry (see _compact_fns)
    _cache_put(_BUCKET_SCHEDULE, sched_key, (camera, counts))
    return epilogue(state, fw, pixel)


def _compact_pass_predicted(scene, cfg, fns, sched, sample_idx):
    """Prediction path: bucket sizes from the recorded schedule using the
    exact path's own quantized sizing (NO headroom — see the in-body
    note), actual alive counts checked against the buckets ON DEVICE with
    a single end-of-pass readback. Returns the (rgb, weight) pass output,
    or None on overflow (caller redoes the pass on the exact path)."""
    (prologue, count_alive, select, gather, bounce_sub, scatter,
     epilogue) = fns
    w, h = cfg.resolution
    n = w * h
    q = cfg.compact_quantum
    state, pixel, fw = prologue(scene, jnp.uint32(sample_idx))
    fit = jnp.bool_(True)
    for depth in range(cfg.max_depth):
        # A zero/absent prediction still gets a one-quantum floor bucket:
        # the schedule comes from a DIFFERENT sample pass, and RR kills
        # differ per sample — breaking out early on k_pred == 0 made
        # every pass whose wavefront outlived pass 0's fail the fit check
        # and redo at double cost.
        #
        # Bucket sizing is IDENTICAL to the exact path's formula (no
        # headroom): any other sizing creates bucket sizes the exact pass
        # never compiled, and each novel size costs a fresh bounce-program
        # compile. Counts that drift across a quantum boundary just
        # overflow-redo that pass (rare, and both sizes are compiled after
        # the first redo).
        k_pred = max(sched[depth] if depth < len(sched) else 0, 1)
        bucket = n if k_pred > n // 2 else min(n, -(-k_pred // q) * q)
        # the actual count must fit the bucket (checked on device)
        fit = fit & (count_alive(state["alive"]) <= bucket)
        if depth == 0 and bucket >= n:
            state = bounce_sub(scene, state, jnp.uint32(depth), pixel,
                               jnp.uint32(sample_idx))
            continue
        idx = select(state["alive"], state["d"], state["o"], bucket)
        if bucket >= n:
            state, pixel = gather(state, pixel, idx)
            state = bounce_sub(scene, state, jnp.uint32(depth), pixel,
                               jnp.uint32(sample_idx))
        else:
            sub, pixel_sub = gather(state, pixel, idx)
            sub_new = bounce_sub(scene, sub, jnp.uint32(depth), pixel_sub,
                                 jnp.uint32(sample_idx))
            state = scatter(state, sub_new, idx)
    rgb, wt = epilogue(state, fw, pixel)
    if not bool(fit):                                   # ONE host sync
        return None
    return rgb, wt


def render_passes(scene, camera, cfg: RenderConfig, filter_obj, sensor,
                  sample_idx0, n_passes: int):
    """n_passes samples-per-pixel in ONE device program: lax.scan over
    per-sample passes accumulating (rgb_sum, weight_sum). Amortizes
    host->device dispatch over the chunk (one launch instead of n).
    Each scan step carries one W*H wavefront; a k*W*H multi-sample
    wavefront is not implemented."""
    w, h = cfg.resolution

    def body(carry, j):
        rgb_sum, wt_sum = carry
        rgb, wt = render_pass(scene, camera, cfg, filter_obj, sensor,
                              sample_idx0 + j)
        return (rgb_sum + rgb * wt[..., None], wt_sum + wt), None

    init = (jnp.zeros((h, w, 3)), jnp.zeros((h, w)))
    (rgb_sum, wt_sum), _ = jax.lax.scan(
        body, init, jnp.arange(n_passes, dtype=jnp.uint32))
    return rgb_sum, wt_sum


# Jitted render programs cached ACROSS render() calls (keyed by config +
# component identities — make_filter/make_sensor are memoized per config,
# so the ids are stable): a fresh jit object per render() call would pay
# a full XLA recompile on every resume-style call.
_RENDER_PROG_CACHE = {}


def _render_progs(cfg, camera, filter_obj, sensor):
    # strong refs stored with the entry pin the id()s (see _compact_fns)
    key = (cfg, id(camera), id(filter_obj), id(sensor))
    if key in _RENDER_PROG_CACHE:
        return _RENDER_PROG_CACHE[key][0]

    @partial(jax.jit, static_argnames=("n",))
    def chunk_pass(scene_, film_, sample_idx, n):
        rgb_sum, wt_sum = render_passes(scene_, camera, cfg, filter_obj,
                                        sensor, sample_idx, n)
        return filmmod.Film(film_.rgb_sum + rgb_sum,
                            film_.weight_sum + wt_sum,
                            film_.spp_done + n)

    @jax.jit
    def accum(film_, rgb, wt):
        return filmmod.Film(film_.rgb_sum + rgb * wt[..., None],
                            film_.weight_sum + wt, film_.spp_done + 1)

    _cache_put(_RENDER_PROG_CACHE, key,
               ((chunk_pass, accum), (camera, filter_obj, sensor)))
    return chunk_pass, accum


def render(scene, camera, cfg: RenderConfig, film=None, progress=None,
           passes=None, chunk=1):
    """Progressive render: cfg.sampler.spp passes accumulated into a Film
    (the MainLoop progressive accumulation, RayTracerTestApp.h:420-422).

    Resume: pass a checkpointed ``film`` — rendering continues at
    ``film.spp_done`` with identical sample values (counter-based RNG).
    NOTE the sampler's stratification depends on the *total* ``spp``; a
    partial render intended for later resume must use the same cfg and stop
    early via ``passes``.

    chunk: samples per device launch (lax.scan inside jit). chunk=1 keeps
    per-spp progress callbacks; larger chunks amortize dispatch overhead.

    cfg.compact routes each pass through the host-driven compacted bounce
    loop (render_pass_compact), which carries only the alive rays through
    each bounce, with identical sample values (tests assert compact ==
    non-compact)."""
    filter_obj = make_filter(cfg)
    sensor = make_sensor(cfg)
    if film is None:
        film = filmmod.Film.create(cfg.resolution)
    use_compact = cfg.compact and cfg.integrator != "direct"
    chunk_pass, accum = _render_progs(cfg, camera, filter_obj, sensor)

    start = int(film.spp_done)
    stop = cfg.sampler.spp if passes is None else min(cfg.sampler.spp,
                                                      start + passes)
    i = start
    while i < stop:
        if use_compact:
            rgb, wt = render_pass_compact(scene, camera, cfg, filter_obj,
                                          sensor, jnp.uint32(i))
            film = accum(film, rgb, wt)
            i += 1
        else:
            n = min(chunk, stop - i)
            film = chunk_pass(scene, film, jnp.uint32(i), n)
            i += n
        if progress is not None:
            progress(i - 1, film)
    return film, sensor
