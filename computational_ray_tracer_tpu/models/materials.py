"""Materials and BSDFs: spectral, batched, differentiable.

The reference sketches its shading model in design notes only
(``RayTracer/Shading.h:7-18``: Lambertian r/π, Fresnel reflect/refract with
bounces; ``RayTracerTestApp.h:246-266``: RGBAlbedo material × lights). This
module *implements* that layer array-first:

- materials live in an SoA table (one row per material); each hit gathers its
  row, and every BSDF kind is evaluated branch-free with `where` selection
  (sorted/masked dispatch is the array analog of virtual BSDF calls);
- reflectances are sigmoid-polynomial spectra evaluated at the ray's 8 hero
  wavelengths; conductors carry dense spectral eta/k (the reference's metal
  spectra); dielectrics use Sellmeier-style dense IoR and can disperse;
- everything is differentiable w.r.t. the table parameters (albedo coeffs,
  emission scale, roughness) — the inverse-rendering path (BASELINE config 5).

Kinds: 0 = Lambertian diffuse, 1 = smooth conductor (specular mirror with
spectral Fresnel), 2 = smooth dielectric (specular reflect/refract),
3 = rough conductor (GGX/Trowbridge-Reitz microfacets, Smith shadowing,
spectral Fresnel) — the glossy lobe that makes MIS (Integrator.h "Path")
meaningful.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from computational_ray_tracer_tpu.ops import color as colorlib
from computational_ray_tracer_tpu.ops import spectrum as spec
from computational_ray_tracer_tpu.ops import spectra_data as data
from computational_ray_tracer_tpu.ops import sampling as smp

LAMBERTIAN = 0
CONDUCTOR = 1
DIELECTRIC = 2
ROUGH_CONDUCTOR = 3

INV_PI = 1.0 / math.pi


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class MaterialTable:
    """SoA material parameters; differentiable leaves."""
    kind: jnp.ndarray            # (M,) int32
    albedo_coeffs: jnp.ndarray   # (M, 3) sigmoid-polynomial coefficients
    emission: jnp.ndarray        # (M, 471) dense emitted radiance SPD
    eta: jnp.ndarray             # (M, 471) dense IoR (dielectric/conductor)
    k: jnp.ndarray               # (M, 471) dense extinction (conductor)
    use_texture: jnp.ndarray     # (M,) bool — modulate albedo by scene texture
    roughness: jnp.ndarray       # (M,) GGX alpha (rough conductor)

    def tree_flatten(self):
        return (self.kind, self.albedo_coeffs, self.emission, self.eta,
                self.k, self.use_texture, self.roughness), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def build(cls, mats):
        """mats: list of dicts.
        keys: kind ('diffuse'|'conductor'|'dielectric'|'rough_conductor'),
        albedo_rgb, emission_rgb + emission_scale (illuminant-shaped), or
        emission_dense, metal (named, e.g. 'metal-Au'), glass (named, e.g.
        'glass-BK7'), eta (scalar), roughness (GGX alpha), use_texture."""
        kind_map = {"diffuse": LAMBERTIAN, "conductor": CONDUCTOR,
                    "dielectric": DIELECTRIC,
                    "rough_conductor": ROUGH_CONDUCTOR}
        n = len(mats)
        kind = np.zeros(n, np.int32)
        alb = np.zeros((n, 3), np.float32)
        emission = np.zeros((n, 471), np.float32)
        eta = np.full((n, 471), 1.5, np.float32)
        kk = np.zeros((n, 471), np.float32)
        tex = np.zeros(n, bool)
        rough = np.full(n, 0.1, np.float32)
        rgbs = []
        for i, m in enumerate(mats):
            kind[i] = kind_map[m.get("kind", "diffuse")]
            rough[i] = float(m.get("roughness", 0.1))
            rgbs.append(m.get("albedo_rgb", (0.5, 0.5, 0.5)))
            if "emission_dense" in m:
                emission[i] = np.asarray(m["emission_dense"], np.float32)
            elif "emission_rgb" in m:
                e = colorlib.RGBIlluminantSpectrum.from_rgb(
                    jnp.asarray(m["emission_rgb"], jnp.float32))
                lam = jnp.asarray(data.DENSE_LAMBDA, jnp.float32)
                emission[i] = np.asarray(e(lam)) * m.get(
                    "emission_scale", 1.0)
            if "metal" in m:
                eta[i] = data.METAL_ETA[m["metal"]]
                kk[i] = data.METAL_K[m["metal"]]
            elif "glass" in m:
                eta[i] = data.GLASS_IOR[m["glass"]]
            elif "eta" in m:
                eta[i] = float(m["eta"])
            tex[i] = bool(m.get("use_texture", False))
        coeffs = np.asarray(colorlib.fit_rgb_to_spectrum(
            jnp.asarray(np.asarray(rgbs, np.float32))))
        return cls(jnp.asarray(kind), jnp.asarray(coeffs),
                   jnp.asarray(emission), jnp.asarray(eta), jnp.asarray(kk),
                   jnp.asarray(tex), jnp.asarray(rough))


# ---------------------------------------------------------------------------
# Shading frame helpers
# ---------------------------------------------------------------------------

def build_frame(n):
    """Orthonormal (t, b, n) from normals (branchless Duff et al. frame)."""
    s = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t1 = jnp.stack([1.0 + s * n[..., 0] ** 2 * a, s * b,
                    -s * n[..., 0]], axis=-1)
    t2 = jnp.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], axis=-1)
    return t1, t2


def to_local(t, b, n, w):
    return jnp.stack([jnp.sum(w * t, axis=-1), jnp.sum(w * b, axis=-1),
                      jnp.sum(w * n, axis=-1)], axis=-1)


def to_world(t, b, n, w):
    return (w[..., 0:1] * t + w[..., 1:2] * b + w[..., 2:3] * n)


def reflect(w, n):
    return -w + 2.0 * jnp.sum(w * n, axis=-1, keepdims=True) * n


def refract(wi, n, eta_rel):
    """Snell refraction; returns (wt, total_internal_reflection)."""
    cos_i = jnp.sum(wi * n, axis=-1)
    sin2_i = jnp.maximum(0.0, 1.0 - cos_i ** 2)
    sin2_t = sin2_i / (eta_rel ** 2)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    wt = -wi / eta_rel[..., None] + \
        (cos_i / eta_rel - cos_t)[..., None] * n
    return wt, tir


# ---------------------------------------------------------------------------
# Fresnel (Shading.h:12-16 capability)
# ---------------------------------------------------------------------------

def fresnel_dielectric(cos_i, eta):
    """Unpolarized dielectric Fresnel reflectance; eta = eta_t/eta_i."""
    cos_i = jnp.clip(cos_i, 0.0, 1.0)
    sin2_t = jnp.maximum(0.0, 1.0 - cos_i ** 2) / (eta ** 2)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    r_par = (eta * cos_i - cos_t) / jnp.maximum(eta * cos_i + cos_t, 1e-9)
    r_perp = (cos_i - eta * cos_t) / jnp.maximum(cos_i + eta * cos_t, 1e-9)
    f = 0.5 * (r_par ** 2 + r_perp ** 2)
    return jnp.where(tir, 1.0, f)


def fresnel_conductor(cos_i, eta, k):
    """Unpolarized conductor Fresnel with complex IoR eta - i k."""
    cos_i = jnp.clip(cos_i, 1e-5, 1.0)
    cos2 = cos_i ** 2
    sin2 = 1.0 - cos2
    e2k2 = eta ** 2 + k ** 2
    t0 = e2k2 - sin2
    a2b2 = jnp.sqrt(jnp.maximum(t0 ** 2 + 4.0 * eta ** 2 * k ** 2, 0.0))
    t1 = a2b2 + cos2
    a = jnp.sqrt(jnp.maximum(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * a * cos_i
    rs = (t1 - t2) / jnp.maximum(t1 + t2, 1e-9)
    t3 = cos2 * a2b2 + sin2 ** 2
    t4 = t2 * sin2
    rp = rs * (t3 - t4) / jnp.maximum(t3 + t4, 1e-9)
    return 0.5 * (rs + rp)


# ---------------------------------------------------------------------------
# GGX microfacets (Trowbridge-Reitz NDF, Smith masking) — the glossy lobe
# ---------------------------------------------------------------------------

def ggx_d(cos_h, alpha):
    """Trowbridge-Reitz normal distribution D(h); cos_h = n·h in [0,1]."""
    a2 = alpha * alpha
    c2 = cos_h * cos_h
    denom = c2 * (a2 - 1.0) + 1.0
    return a2 / jnp.maximum(math.pi * denom * denom, 1e-12)


def ggx_g1(cos_v, alpha):
    """Smith masking for one direction (separable form)."""
    a2 = alpha * alpha
    c = jnp.clip(cos_v, 1e-5, 1.0)
    return 2.0 * c / jnp.maximum(c + jnp.sqrt(a2 + (1.0 - a2) * c * c), 1e-12)


def ggx_sample_half(u2, alpha):
    """Sample a half-vector from the GGX NDF (local frame, +z up).
    cosθ_h = sqrt((1-u)/(1+(α²-1)u)); pdf_h = D(h)·cosθ_h."""
    a2 = alpha * alpha
    cos_h = jnp.sqrt(jnp.clip((1.0 - u2[..., 0])
                              / (1.0 + (a2 - 1.0) * u2[..., 0]), 0.0, 1.0))
    sin_h = jnp.sqrt(jnp.maximum(1.0 - cos_h * cos_h, 0.0))
    phi = 2.0 * math.pi * u2[..., 1]
    return jnp.stack([sin_h * jnp.cos(phi), sin_h * jnp.sin(phi), cos_h],
                     axis=-1)


def _rough_conductor_fpdf(wo_l, wi_l, alpha, eta_s, k_s, spec_tint):
    """(f (..., S), pdf (...,)) of the GGX conductor lobe in local frame."""
    cos_o = wo_l[..., 2]
    cos_i = wi_l[..., 2]
    same = (cos_o > 1e-5) & (cos_i > 1e-5)
    h = wo_l + wi_l
    h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-12)
    cos_h = jnp.clip(h[..., 2], 0.0, 1.0)
    odoth = jnp.maximum(jnp.sum(wo_l * h, axis=-1), 1e-6)
    d_val = ggx_d(cos_h, alpha)
    g = ggx_g1(cos_o, alpha) * ggx_g1(cos_i, alpha)
    fr = fresnel_conductor(odoth[..., None], eta_s, k_s) * spec_tint
    denom = jnp.maximum(4.0 * cos_o * cos_i, 1e-6)
    f = fr * (d_val * g / denom)[..., None]
    pdf = d_val * cos_h / (4.0 * odoth)
    f = jnp.where(same[..., None], f, 0.0)
    pdf = jnp.where(same, pdf, 0.0)
    return f, pdf


# ---------------------------------------------------------------------------
# Batched BSDF interface
# ---------------------------------------------------------------------------

def _gather(mat: MaterialTable, mid):
    return jax.tree_util.tree_map(lambda x: x[mid], mat)


from computational_ray_tracer_tpu.ops.numeric import select_rows as \
    _select_rows  # clamped small-table row select


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class MaterialView:
    """Lazy per-ray view into a MaterialTable: small fields gathered
    eagerly, dense (M, 471) SPD fields left in place and fetched with a
    single fused (row, wavelength) gather at evaluation time — avoids
    materializing (N, 471) rows per bounce (the former hot-path gather)."""
    kind: Any                  # (N,)  gathered
    albedo_coeffs: Any         # (N, 3) gathered
    use_texture: Any           # (N,)  gathered
    roughness: Any             # (N,)  gathered
    emission_table: Any        # (M, 471) ungathered
    eta_table: Any             # (M, 471)
    k_table: Any               # (M, 471)
    mid: Any                   # (N,) row index

    def tree_flatten(self):
        return (self.kind, self.albedo_coeffs, self.use_texture,
                self.roughness, self.emission_table, self.eta_table,
                self.k_table, self.mid), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def create(cls, table: MaterialTable, mid):
        return cls(_select_rows(table.kind, mid),
                   _select_rows(table.albedo_coeffs, mid),
                   _select_rows(table.use_texture, mid),
                   _select_rows(table.roughness, mid),
                   table.emission, table.eta, table.k, mid)


def _emission_at(mat_row, lam):
    if isinstance(mat_row, MaterialView):
        return spec.sample_dense_rows(mat_row.emission_table, mat_row.mid,
                                      lam)
    return spec.sample_dense(mat_row.emission, lam)


def _eta_at(mat_row, lam):
    if isinstance(mat_row, MaterialView):
        return spec.sample_dense_rows(mat_row.eta_table, mat_row.mid, lam)
    return spec.sample_dense(mat_row.eta, lam)


def _k_at(mat_row, lam):
    if isinstance(mat_row, MaterialView):
        return spec.sample_dense_rows(mat_row.k_table, mat_row.mid, lam)
    return spec.sample_dense(mat_row.k, lam)


def material_spectra(mat_row, lam):
    """(emission, eta, k) at the hero wavelengths in ONE fused dense-table
    evaluation (the per-bounce bundle — builds the interpolation weights
    once for all three tables instead of three serialized gathers)."""
    if isinstance(mat_row, MaterialView):
        return spec.sample_dense_rows_multi(
            (mat_row.emission_table, mat_row.eta_table, mat_row.k_table),
            mat_row.mid, lam)
    return (spec.sample_dense(mat_row.emission, lam),
            spec.sample_dense(mat_row.eta, lam),
            spec.sample_dense(mat_row.k, lam))


def material_albedo(mat_row, lam, tex_rgb_coeffs=None):
    """Spectral reflectance at the hero wavelengths; optionally modulated by
    a texture's own sigmoid coefficients (the uvmap fetch of
    RayTracerTestApp.h:252-259)."""
    alb = colorlib.sigmoid_polynomial(mat_row.albedo_coeffs, lam)
    if tex_rgb_coeffs is not None:
        tex = colorlib.sigmoid_polynomial(tex_rgb_coeffs, lam)
        use = mat_row.use_texture[..., None]
        alb = jnp.where(use, alb * tex, alb)
    return alb


def material_emission(mat_row, lam):
    """Emitted radiance at the hero wavelengths (fused dense gather)."""
    return _emission_at(mat_row, lam)


def bsdf_eval(mat_row, n, wo, wi, lam, tex_rgb_coeffs=None, eta_k=None,
              enable_rough=True):
    """f(wo, wi) (..., S) and pdf(wi) (...,) for the *sampleable* lobes
    (Lambertian + GGX rough conductor). Delta kinds evaluate to 0.

    ``eta_k``: optional precomputed (eta, k) spectra to share the dense
    gather with the caller (only needed when rough conductors are present).
    """
    cos_o = jnp.sum(n * wo, axis=-1)
    cos_i = jnp.sum(n * wi, axis=-1)
    same_hemi = (cos_o > 0) & (cos_i > 0)
    alb = material_albedo(mat_row, lam, tex_rgb_coeffs)
    f_diffuse = alb * INV_PI
    pdf_diffuse = jnp.maximum(cos_i, 0.0) * INV_PI
    is_diffuse = mat_row.kind == LAMBERTIAN
    f = jnp.where((is_diffuse & same_hemi)[..., None], f_diffuse, 0.0)
    pdf = jnp.where(is_diffuse & same_hemi, pdf_diffuse, 0.0)

    if enable_rough:
        is_rough = mat_row.kind == ROUGH_CONDUCTOR
        t, b = build_frame(n)
        wo_l = to_local(t, b, n, wo)
        wi_l = to_local(t, b, n, wi)
        if eta_k is not None:
            eta_s, k_s = eta_k
        else:
            eta_s = _eta_at(mat_row, lam)
            k_s = _k_at(mat_row, lam)
        tint = colorlib.sigmoid_polynomial(mat_row.albedo_coeffs, lam)
        f_r, pdf_r = _rough_conductor_fpdf(wo_l, wi_l, mat_row.roughness,
                                           eta_s, k_s, tint)
        f = jnp.where(is_rough[..., None], f_r, f)
        pdf = jnp.where(is_rough, pdf_r, pdf)
    return f, pdf


def bsdf_sample(mat_row, n, wo, u2, u1, lam, wl_pdf=None,
                tex_rgb_coeffs=None, eta_k=None, backface=None,
                enable_rough=True):
    """Sample an outgoing direction for every hit in the batch.

    Returns (wi, weight (..., S), pdf, is_specular, terminate_secondary):
    ``weight`` is f·|cos|/pdf (throughput multiplier). Sampling decisions use
    detached values; the returned weight stays differentiable w.r.t. material
    parameters (detached-sampling reparameterization, SURVEY §7 #5).

    ``eta_k``: optional precomputed (eta, k) spectra (from
    :func:`material_spectra`) so the per-bounce dense-table evaluation is
    shared with the emission fetch.

    ``backface``: (...,) bool — the ray struck the geometric back side, i.e.
    it is EXITING a closed shape (SurfaceInfo.backface). Required for correct
    dielectric eta selection: ``n`` is face-forwarded toward ``wo``, so
    ``dot(n, wo) > 0`` always holds and carries no inside/outside signal.
    """
    t, b = build_frame(n)
    wo_l = to_local(t, b, n, wo)

    # --- Lambertian: cosine-hemisphere sample
    wi_l_diff = smp.sample_cosine_hemisphere(u2)
    wi_diff = to_world(t, b, n, wi_l_diff)
    alb = material_albedo(mat_row, lam, tex_rgb_coeffs)
    # weight = (alb/pi * cos / (cos/pi)) = alb
    w_diff = alb
    pdf_diff = jnp.maximum(wi_l_diff[..., 2], 1e-9) * INV_PI

    # --- Conductor: mirror reflection with spectral Fresnel
    wi_spec = reflect(wo, n)
    cos_i = jnp.abs(jnp.sum(n * wo, axis=-1))
    if eta_k is not None:
        eta_s, k_s = eta_k                            # (..., S) each
    else:
        eta_s = _eta_at(mat_row, lam)
        k_s = _k_at(mat_row, lam)
    fr_cond = fresnel_conductor(cos_i[..., None], eta_s, k_s)
    tint = colorlib.sigmoid_polynomial(mat_row.albedo_coeffs, lam)
    w_cond = fr_cond * tint

    # --- Rough conductor: GGX half-vector sample, weight = f·cos/pdf
    if enable_rough:
        h_l = ggx_sample_half(jax.lax.stop_gradient(u2), mat_row.roughness)
        wo_dot_h = jnp.sum(wo_l * h_l, axis=-1)
        wi_l_rough = 2.0 * wo_dot_h[..., None] * h_l - wo_l
        wi_rough = to_world(t, b, n, wi_l_rough)
        f_rough, pdf_rough = _rough_conductor_fpdf(
            wo_l, wi_l_rough, mat_row.roughness, eta_s, k_s, tint)
        cos_i_rough = jnp.maximum(wi_l_rough[..., 2], 0.0)
        w_rough = f_rough * (cos_i_rough
                             / jnp.maximum(pdf_rough, 1e-12))[..., None]
        w_rough = jnp.where((pdf_rough > 1e-12)[..., None], w_rough, 0.0)
    else:
        wi_rough, w_rough = wi_spec, w_cond
        pdf_rough = jnp.ones(wo.shape[:-1])

    # --- Dielectric: Fresnel-weighted reflect/refract at the hero wavelength.
    # eta_rel = eta_transmitted / eta_incident relative to the (flipped) n:
    # entering (front face) -> eta; exiting (back face) -> 1/eta.
    eta_hero = eta_s[..., 0]
    if backface is None:
        entering = jnp.sum(n * wo, axis=-1) > 0   # legacy single-sided calls
    else:
        entering = ~backface
    eta_rel = jnp.where(entering, eta_hero, 1.0 / eta_hero)
    fr = fresnel_dielectric(cos_i, eta_rel)
    choose_reflect = jax.lax.stop_gradient(u1) < fr
    wt, tir = refract(wo, n, eta_rel)
    wt = wt / jnp.maximum(jnp.linalg.norm(wt, axis=-1, keepdims=True), 1e-9)
    wi_diel = jnp.where((choose_reflect | tir)[..., None], wi_spec, wt)
    # radiance transport: refraction scales by 1/eta_rel^2
    w_refr = jnp.broadcast_to((1.0 / eta_rel ** 2)[..., None], lam.shape)
    w_diel = jnp.where((choose_reflect | tir)[..., None],
                       jnp.ones_like(lam), w_refr)
    # Dispersion: dielectric paths collapse secondary wavelengths
    terminate = mat_row.kind == DIELECTRIC

    kind = mat_row.kind
    # delta lobes only; the GGX lobe is sampleable (MIS applies to it)
    is_spec = (kind == CONDUCTOR) | (kind == DIELECTRIC)
    wi = jnp.where((kind == LAMBERTIAN)[..., None], wi_diff,
                   jnp.where((kind == CONDUCTOR)[..., None], wi_spec,
                             jnp.where((kind == ROUGH_CONDUCTOR)[..., None],
                                       wi_rough, wi_diel)))
    weight = jnp.where((kind == LAMBERTIAN)[..., None], w_diff,
                       jnp.where((kind == CONDUCTOR)[..., None], w_cond,
                                 jnp.where((kind == ROUGH_CONDUCTOR)[..., None],
                                           w_rough, w_diel)))
    pdf = jnp.where(kind == LAMBERTIAN, pdf_diff,
                    jnp.where(kind == ROUGH_CONDUCTOR, pdf_rough, 1.0))
    return wi, weight, pdf, is_spec, terminate
