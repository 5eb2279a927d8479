"""Lights: point / distant / quad-area / ambient, with NEE sampling.

The reference sketches lights as a design note only
(``RayTracer/Lights.h:5-8``: point + sun with r² falloff) and uses an inline
ambient + cosine "white light" in its integrator (``RayTracerTestApp.h:
246-266``). This module implements the light layer array-first: an SoA table of
all lights; ``sample_light`` draws one light per ray (uniform light pick +
per-kind position sample) and returns direction, distance, spectral radiance
and pdf — all branch-free selected, differentiable w.r.t. light parameters
(emission scale is a leaf).

Kinds: 0 = point (intensity / r²), 1 = distant/sun, 2 = quad area light
(parallelogram, one-sided), 3 = ambient/constant environment.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp

from computational_ray_tracer_tpu.ops import spectrum as spec
from computational_ray_tracer_tpu.ops import spectra_data as data
from computational_ray_tracer_tpu.ops import color as colorlib

POINT = 0
DISTANT = 1
AREA_QUAD = 2
AMBIENT = 3


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class LightTable:
    kind: jnp.ndarray       # (L,) int32
    position: jnp.ndarray   # (L, 3) point position / quad corner
    direction: jnp.ndarray  # (L, 3) distant dir (unit, pointing FROM light)
    edge1: jnp.ndarray      # (L, 3) quad edges
    edge2: jnp.ndarray      # (L, 3)
    spd: jnp.ndarray        # (L, 471) dense spectral intensity/radiance
    scale: jnp.ndarray      # (L,) differentiable emission scale

    def tree_flatten(self):
        return (self.kind, self.position, self.direction, self.edge1,
                self.edge2, self.spd, self.scale), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def n_lights(self):
        return self.kind.shape[0]

    @classmethod
    def build(cls, lights):
        """lights: list of dicts. Common keys: kind, scale, and one of
        spd_named (registry name), spd_dense, rgb (illuminant-shaped).
        Point: position. Distant: direction. Quad: corner, edge1, edge2.
        Ambient: nothing else."""
        kind_map = {"point": POINT, "distant": DISTANT, "quad": AREA_QUAD,
                    "ambient": AMBIENT}
        n = len(lights)
        kind = np.zeros(n, np.int32)
        pos = np.zeros((n, 3), np.float32)
        dirn = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (n, 1))
        e1 = np.zeros((n, 3), np.float32)
        e2 = np.zeros((n, 3), np.float32)
        spd = np.zeros((n, 471), np.float32)
        scale = np.ones(n, np.float32)
        for i, l in enumerate(lights):
            kind[i] = kind_map[l["kind"]]
            scale[i] = float(l.get("scale", 1.0))
            if "spd_named" in l:
                spd[i] = data.get_named_spectrum(l["spd_named"])
            elif "spd_dense" in l:
                spd[i] = np.asarray(l["spd_dense"], np.float32)
            elif "rgb" in l:
                e = colorlib.RGBIlluminantSpectrum.from_rgb(
                    jnp.asarray(l["rgb"], jnp.float32))
                spd[i] = np.asarray(e(jnp.asarray(data.DENSE_LAMBDA,
                                                  jnp.float32)))
            else:
                spd[i] = data.ILLUM_E
            if "position" in l:
                pos[i] = np.asarray(l["position"], np.float32)
            if "corner" in l:
                pos[i] = np.asarray(l["corner"], np.float32)
            if "direction" in l:
                d = np.asarray(l["direction"], np.float64)
                dirn[i] = (d / np.linalg.norm(d)).astype(np.float32)
            if "edge1" in l:
                e1[i] = np.asarray(l["edge1"], np.float32)
                e2[i] = np.asarray(l["edge2"], np.float32)
        return cls(jnp.asarray(kind), jnp.asarray(pos), jnp.asarray(dirn),
                   jnp.asarray(e1), jnp.asarray(e2), jnp.asarray(spd),
                   jnp.asarray(scale))


def sample_light(table: LightTable, p, n, lam, u_light, u_pos,
                 world_radius=100.0, spd_vals=None):
    """Next-event sample toward one light per shading point.

    p, n: (..., 3) shading position/normal. lam: (..., S). u_light: (...,)
    uniform for light selection; u_pos: (..., 2) for position on the light.

    ``spd_vals``: optional pre-interpolated light SPDs at the hero
    wavelengths, (..., S, L) (the per-pass spectral cache,
    integrator._spectral_cache) — skips the per-call dense-table
    interpolation; values are bitwise identical to interpolating here.

    Returns (wi, dist, Li (..., S), pdf, light_n_dot) where pdf is the full
    solid-angle-measure pdf including the 1/n_lights selection factor, and Li
    already folds the point-light 1/r² (Lights.h:5-8) and quad one-sidedness.
    """
    from computational_ray_tracer_tpu.ops.numeric import select_rows
    nl = table.n_lights
    li = jnp.clip((jax.lax.stop_gradient(u_light) * nl).astype(jnp.int32),
                  0, nl - 1)
    # clamped row gathers from the (tiny) light tables
    kind = select_rows(table.kind, li)
    pos_l = select_rows(table.position, li)
    dir_l = select_rows(table.direction, li)
    e1_l = select_rows(table.edge1, li)
    e2_l = select_rows(table.edge2, li)
    scale_l = select_rows(table.scale, li)
    if spd_vals is not None:
        spd_interp = spd_vals[..., 0]
        for k in range(1, nl):               # static-L where-chain select
            spd_interp = jnp.where((li == k)[..., None], spd_vals[..., k],
                                   spd_interp)
    else:
        spd_interp = spec.sample_dense_rows(table.spd, li, lam)
    spd_at = spd_interp * scale_l[..., None]

    # --- point
    to_l = pos_l - p
    dist2 = jnp.maximum(jnp.sum(to_l * to_l, axis=-1), 1e-12)
    dist_point = jnp.sqrt(dist2)
    wi_point = to_l / dist_point[..., None]
    li_point = spd_at / dist2[..., None]

    # --- distant (sun): radiance along -direction, "infinite" distance
    wi_dist = -dir_l
    li_dist = spd_at

    # --- quad area light: uniform point on parallelogram
    qp = (pos_l + u_pos[..., 0:1] * e1_l + u_pos[..., 1:2] * e2_l)
    qn = jnp.cross(e1_l, e2_l)
    area = jnp.maximum(jnp.linalg.norm(qn, axis=-1), 1e-12)
    qn = qn / area[..., None]
    to_q = qp - p
    dq2 = jnp.maximum(jnp.sum(to_q * to_q, axis=-1), 1e-12)
    dq = jnp.sqrt(dq2)
    wi_quad = to_q / dq[..., None]
    cos_l = jnp.sum(-wi_quad * qn, axis=-1)  # one-sided: emit along +qn side
    front = cos_l > 0
    # area-measure -> solid-angle pdf
    pdf_quad = dq2 / jnp.maximum(area * jnp.abs(cos_l), 1e-12)
    li_quad = jnp.where(front[..., None], spd_at, 0.0)

    # --- ambient: cosine-weighted environment
    from computational_ray_tracer_tpu.ops import sampling as smp
    from computational_ray_tracer_tpu.models.materials import (build_frame,
                                                               to_world)
    t_, b_ = build_frame(n)
    wi_amb = to_world(t_, b_, n, smp.sample_cosine_hemisphere(u_pos))
    pdf_amb = jnp.maximum(jnp.sum(wi_amb * n, axis=-1), 1e-9) / math.pi
    li_amb = spd_at

    def sel_vec(v0, v1, v2, v3):
        kk = kind[..., None]
        return jnp.where(kk == POINT, v0,
                         jnp.where(kk == DISTANT, v1,
                                   jnp.where(kk == AREA_QUAD, v2, v3)))

    def sel_scalar(v0, v1, v2, v3):
        return jnp.where(kind == POINT, v0,
                         jnp.where(kind == DISTANT, v1,
                                   jnp.where(kind == AREA_QUAD, v2, v3)))

    wi = sel_vec(wi_point, wi_dist, wi_quad, wi_amb)
    far = jnp.full_like(dist_point, world_radius)
    dist = sel_scalar(dist_point, far, dq, far)
    li = sel_vec(li_point, li_dist, li_quad, li_amb)
    pdf = sel_scalar(jnp.ones_like(dist_point), jnp.ones_like(dist_point),
                     pdf_quad, pdf_amb)
    pdf = pdf / nl  # uniform light selection
    return wi, dist, li, pdf, kind


def env_radiance(table: LightTable, lam, spd_vals=None):
    """Radiance an *escaped* ray collects from the ambient/environment
    lights: Σ_ambient spd·scale at the hero wavelengths. Returns
    (L_env (..., S), n_ambient) — n_ambient is a static-shape int array used
    for the MIS selection factor.

    ``spd_vals``: optional per-ray pre-interpolated SPDs (..., S, L) (the
    per-pass spectral cache). Interpolation is linear in the table, so the
    weighted sum over pre-interpolated lights equals interpolating the
    weighted-sum curve (up to f32 reassociation ~1e-7)."""
    is_amb = table.kind == AMBIENT
    w = jnp.where(is_amb, table.scale, 0.0)           # (L,)
    if spd_vals is not None:
        L = jnp.einsum("...sl,l->...s", spd_vals, w, precision="highest")
    else:
        spd = jnp.einsum("l,ls->s", w, table.spd,
                         precision="highest")          # (471,)
        L = spec.sample_dense(
            jnp.broadcast_to(spd, lam.shape[:-1] + (471,)), lam)
    return L, jnp.sum(is_amb)


def pdf_ambient_direction(table: LightTable, n_prev, d):
    """Solid-angle pdf that :func:`sample_light` at a vertex with shading
    normal ``n_prev`` produced the escaped direction ``d`` via an ambient
    light (cosine-hemisphere sampling): (n_amb/n_lights)·cosθ/π."""
    n_amb = jnp.sum(table.kind == AMBIENT).astype(jnp.float32)
    cos = jnp.maximum(jnp.sum(n_prev * d, axis=-1), 0.0)
    return (n_amb / table.n_lights) * cos / math.pi


def pdf_light_direction(table: LightTable, p, d, t_hit, rel_tol=1e-2):
    """Solid-angle pdf that :func:`sample_light` from point ``p`` would have
    produced the (unit) direction ``d`` whose surface hit lies at ``t_hit``.

    The MIS "light pdf of the BSDF sample" (the Path integrator intent,
    Integrator.h:4-12). Only non-delta, hittable lights contribute:

    - quad area lights: intersect the ray with the parallelogram; if the hit
      parameter matches ``t_hit`` (the emissive geometry is co-located with
      the light), pdf = t²/(A·|cosθ_l|);
    - point/distant lights are delta distributions a BSDF sample cannot hit
      (pdf 0); ambient applies to escaped rays only (handled by the caller).

    Returns (...,) pdf including the uniform 1/n_lights selection factor,
    summed over all matching lights.
    """
    nl = table.n_lights
    pdf = jnp.zeros(t_hit.shape)
    # Vectorize over the (small) light table: add a trailing light axis.
    pe = p[..., None, :]                      # (..., 1, 3)
    de = d[..., None, :]
    corner = table.position                    # (L, 3)
    e1 = table.edge1
    e2 = table.edge2
    qn = jnp.cross(e1, e2)                     # (L, 3) unnormalized
    area = jnp.maximum(jnp.linalg.norm(qn, axis=-1), 1e-12)
    qn_u = qn / area[..., None]
    denom = jnp.sum(de * qn_u, axis=-1)        # (..., L)
    safe_denom = jnp.where(jnp.abs(denom) < 1e-9, 1.0, denom)
    t_q = jnp.sum((corner - pe) * qn_u, axis=-1) / safe_denom
    hitp = pe + de * t_q[..., None]            # (..., L, 3)
    rel = hitp - corner
    # Parallelogram coordinates via the dual basis (e1, e2 need not be
    # orthogonal): solve [e1.e1 e1.e2; e2.e1 e2.e2] [a b]' = [rel.e1 rel.e2]'
    g11 = jnp.sum(e1 * e1, axis=-1)
    g12 = jnp.sum(e1 * e2, axis=-1)
    g22 = jnp.sum(e2 * e2, axis=-1)
    det = jnp.maximum(g11 * g22 - g12 * g12, 1e-20)
    r1 = jnp.sum(rel * e1, axis=-1)
    r2 = jnp.sum(rel * e2, axis=-1)
    a = (g22 * r1 - g12 * r2) / det
    b = (g11 * r2 - g12 * r1) / det
    cos_l = jnp.sum(-de * qn_u, axis=-1)       # one-sided (emits along +qn)
    ok = ((table.kind == AREA_QUAD)
          & (jnp.abs(denom) >= 1e-9)
          & (t_q > 0.0)
          & (a >= -1e-4) & (a <= 1.0 + 1e-4)
          & (b >= -1e-4) & (b <= 1.0 + 1e-4)
          & (cos_l > 1e-6)
          & (jnp.abs(t_q - t_hit[..., None])
             <= rel_tol * jnp.maximum(t_hit[..., None], 1e-6)))
    pdf_quad = t_q ** 2 / jnp.maximum(area * jnp.abs(cos_l), 1e-12)
    pdf = jnp.sum(jnp.where(ok, pdf_quad, 0.0), axis=-1)
    return pdf / nl
