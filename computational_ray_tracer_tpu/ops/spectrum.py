"""Hero-wavelength spectral core.

Capability parity with the reference's PBRT-v4 spectral layer
(``/root/reference/ThirdParty/pbrv4/spectrum.h:17-723``), designed array-first:

- A "SampledSpectrum" is just a jnp array with a trailing axis of
  ``N_SPECTRUM_SAMPLES`` (= 8, matching spectrum.h:19). All radiance /
  throughput math is ordinary vectorized jnp and fuses into surrounding ops.
- "SampledWavelengths" is a pair of ``(..., 8)`` arrays (lambda, pdf) produced
  by stratified uniform or importance (visible) sampling from a single u.
- Spectrum *distributions* are pytree dataclasses with a ``__call__(lam)``
  method; dense tables sample via ``jnp.interp``-style gathers.

Everything is differentiable and shape-polymorphic over leading batch dims.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from computational_ray_tracer_tpu.ops import spectra_data as data

LAMBDA_MIN = data.LAMBDA_MIN
LAMBDA_MAX = data.LAMBDA_MAX
N_SPECTRUM_SAMPLES = data.N_SPECTRUM_SAMPLES
CIE_Y_INTEGRAL = data.CIE_Y_INTEGRAL


# ---------------------------------------------------------------------------
# SampledSpectrum helpers (ops on (..., 8) arrays)
# ---------------------------------------------------------------------------

def safe_div(a, b):
    """a/b with 0 where b == 0 (SampledSpectrum::SafeDiv, spectrum.h:666)."""
    return jnp.where(b != 0.0, a / jnp.where(b != 0.0, b, 1.0), 0.0)


def average(s):
    """Mean over the wavelength axis."""
    return jnp.mean(s, axis=-1)


def spectrum_clamp(s, lo=0.0, hi=jnp.inf):
    return jnp.clip(s, lo, hi)


def spectrum_lerp(t, a, b):
    return a + (b - a) * t[..., None] if jnp.ndim(t) == jnp.ndim(a) - 1 else a + (b - a) * t


# ---------------------------------------------------------------------------
# SampledWavelengths: (..., 8) lambda + pdf
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SampledWavelengths:
    """Hero wavelengths + their sampling pdf (spectrum.h:253-343)."""
    lam: jnp.ndarray   # (..., S)
    pdf: jnp.ndarray   # (..., S)

    def tree_flatten(self):
        return (self.lam, self.pdf), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def terminate_secondary(self):
        """Collapse to the hero wavelength for dispersive paths
        (TerminateSecondary, spectrum.h:302-319)."""
        s = self.lam.shape[-1]
        already = self.secondary_terminated()
        new_pdf = jnp.concatenate(
            [self.pdf[..., :1] / s, jnp.zeros_like(self.pdf[..., 1:])], axis=-1)
        pdf = jnp.where(already[..., None], self.pdf, new_pdf)
        return SampledWavelengths(self.lam, pdf)

    def secondary_terminated(self):
        return jnp.all(self.pdf[..., 1:] == 0.0, axis=-1)


def sample_uniform_wavelengths(u, lam_min=LAMBDA_MIN, lam_max=LAMBDA_MAX,
                               n=N_SPECTRUM_SAMPLES):
    """Stratified uniform hero wavelengths from a single u in [0,1)
    (SampleUniform, spectrum.h:270-291): lam0 = lerp(u), the rest advance by
    delta and wrap."""
    u = jnp.asarray(u)
    delta = (lam_max - lam_min) / n
    lam0 = lam_min + u[..., None] * (lam_max - lam_min)
    offs = jnp.arange(n, dtype=lam0.dtype) * delta
    lam = lam0 + offs
    lam = jnp.where(lam > lam_max, lam_min + (lam - lam_max), lam)
    pdf = jnp.full_like(lam, 1.0 / (lam_max - lam_min))
    return SampledWavelengths(lam, pdf)


def visible_wavelengths_pdf(lam):
    """pdf of the visible-importance distribution over [360, 830]
    (Sampling.h:63-65 / PBRT VisibleWavelengthsPDF)."""
    x = jnp.cosh(0.0072 * (lam - 538.0))
    pdf = 0.0039398042 / (x * x)
    return jnp.where((lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX), pdf, 0.0)


def sample_visible_wavelength(u):
    """Inverse-CDF sample of the visible distribution (Sampling.h:67-71)."""
    return 538.0 - 138.888889 * jnp.arctanh(0.85691062 - 1.82750197 * u)


def sample_visible_wavelengths(u, n=N_SPECTRUM_SAMPLES):
    """Stratified importance-sampled hero wavelengths (SampleVisible,
    spectrum.h:322-336): each slot uses up = wrap(u + i/n)."""
    u = jnp.asarray(u)
    i = jnp.arange(n, dtype=u.dtype)
    up = u[..., None] + (i + 0.0) / n
    up = jnp.where(up > 1.0, up - 1.0, up)
    lam = sample_visible_wavelength(up)
    pdf = visible_wavelengths_pdf(lam)
    return SampledWavelengths(lam, pdf)


# ---------------------------------------------------------------------------
# Dense-table sampling (shared gather kernel)
# ---------------------------------------------------------------------------

_DENSE_LAMBDA_J = jnp.asarray(data.DENSE_LAMBDA, dtype=jnp.float32)


def sample_dense(table, lam):
    """Linearly interpolate a dense (471,) 1nm table at wavelengths lam.

    Out-of-range wavelengths return 0 (DenselySampledSpectrum semantics,
    spectrum.h:376-456). `table` may have leading batch dims matching lam's.
    """
    table = jnp.asarray(table)
    x = (lam - LAMBDA_MIN)
    i0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, data.N_DENSE - 2)
    w = jnp.clip(x - i0.astype(lam.dtype), 0.0, 1.0)
    if table.ndim == 1:
        v0 = jnp.take(table, i0, axis=-1)
        v1 = jnp.take(table, i0 + 1, axis=-1)
    else:
        # Batched tables: table (..., 471) aligned with lam's batch dims.
        v0 = jnp.take_along_axis(table, i0, axis=-1)
        v1 = jnp.take_along_axis(table, i0 + 1, axis=-1)
    v = v0 * (1.0 - w) + v1 * w
    inside = (lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX)
    return jnp.where(inside, v, 0.0)


def _dense_idx_frac(lam):
    x = lam - LAMBDA_MIN
    i0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, data.N_DENSE - 2)
    w = jnp.clip(x - i0.astype(lam.dtype), 0.0, 1.0)
    inside = (lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX)
    return i0, w, inside


def sample_dense_multi(tables, lam):
    """Interpolate C dense 1nm SPDs at once: tables (471, C), lam (..., S)
    -> (..., S, C). Out-of-range wavelengths return 0.

    Gathers whole (C,) rows, so batching every curve needed at the same
    wavelengths into one call shares the index arithmetic."""
    tables = jnp.asarray(tables)
    i0, w, inside = _dense_idx_frac(lam)
    v0 = tables[i0]                     # (..., S, C) contiguous rows
    v1 = tables[i0 + 1]
    v = v0 * (1.0 - w[..., None]) + v1 * w[..., None]
    return jnp.where(inside[..., None], v, 0.0)


def sample_dense_rows(table, rows, lam):
    """Interpolate per-ray rows of a dense SPD table at the hero
    wavelengths: table (M, 471), rows (...,) int32, lam (..., S) -> (..., S).

    Equivalent to ``sample_dense(table[rows], lam)`` but never materializes
    the (..., 471) gathered rows: two scalar gathers from the flat table.

    Out-of-range ``rows`` are CLAMPED to [0, M); callers with sentinel rows
    must mask the result themselves."""
    table = jnp.asarray(table)
    m = table.shape[0]
    rows = jnp.clip(rows, 0, m - 1)
    i0, w, inside = _dense_idx_frac(lam)
    base = rows[..., None].astype(jnp.int32) * data.N_DENSE
    flat = table.reshape(-1)
    v0 = flat[base + i0]
    v1 = flat[base + i0 + 1]
    v = v0 * (1.0 - w) + v1 * w
    return jnp.where(inside, v, 0.0)


def sample_dense_rows_multi(tables, rows, lam):
    """Per-ray rows of SEVERAL (M, 471) tables at the same wavelengths:
    tables a sequence of G arrays each (M, 471) -> tuple of G arrays
    (..., S) (the per-bounce pattern: emission + eta + k)."""
    return tuple(sample_dense_rows(t, rows, lam) for t in tables)


# ---------------------------------------------------------------------------
# Spectrum distribution classes (pytrees with __call__(lam) -> values)
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ConstantSpectrum:
    """spectrum.h:357-374."""
    c: Any

    def tree_flatten(self):
        return (self.c,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def __call__(self, lam):
        return jnp.broadcast_to(jnp.asarray(self.c), jnp.shape(lam))

    def max_value(self):
        return jnp.asarray(self.c)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DenselySampledSpectrum:
    """1nm LUT over [360, 830] (spectrum.h:376-456)."""
    values: jnp.ndarray  # (471,)

    def tree_flatten(self):
        return (self.values,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def from_named(cls, name: str):
        return cls(jnp.asarray(data.get_named_spectrum(name)))

    @classmethod
    def from_spectrum(cls, spec):
        return cls(spec(_DENSE_LAMBDA_J))

    def __call__(self, lam):
        return sample_dense(self.values, lam)

    def max_value(self):
        return jnp.max(self.values)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class PiecewiseLinearSpectrum:
    """Sorted (lambda, value) control points, linear interp, 0 outside
    (spectrum.h:458-496)."""
    lams: jnp.ndarray
    values: jnp.ndarray

    def tree_flatten(self):
        return (self.lams, self.values), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def from_interleaved(cls, samples, normalize=False):
        """Alternating [lam0, v0, lam1, v1, ...] (spectrum.cpp:60-160)."""
        samples = np.asarray(samples, dtype=np.float32)
        lams, vals = samples[0::2], samples[1::2]
        if normalize:
            spec = cls(jnp.asarray(lams), jnp.asarray(vals))
            scale = CIE_Y_INTEGRAL / inner_product(spec, DenselySampledSpectrum(
                jnp.asarray(data.CIE_Y)))
            vals = vals * float(scale)
        return cls(jnp.asarray(lams), jnp.asarray(vals))

    def __call__(self, lam):
        v = jnp.interp(lam, self.lams, self.values)
        inside = (lam >= self.lams[0]) & (lam <= self.lams[-1])
        return jnp.where(inside, v, 0.0)

    def max_value(self):
        return jnp.max(self.values)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BlackbodySpectrum:
    """Planck emitter normalized to peak 1 via Wien displacement
    (spectrum.h:24-36, 498-531). Differentiable in T."""
    T: Any

    def tree_flatten(self):
        return (self.T,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def __call__(self, lam):
        T = jnp.asarray(self.T, dtype=jnp.float32)
        lam_m = lam * 1e-9
        c, h, kb = 299792458.0, 6.62606957e-34, 1.3806488e-23
        le = (2.0 * h * c * c) / (lam_m ** 5 * jnp.expm1((h * c) / (lam_m * kb * T)))
        lam_max = 2.8977721e-3 / T
        norm = (2.0 * h * c * c) / (lam_max ** 5 * jnp.expm1((h * c) / (lam_max * kb * T)))
        return le / norm

    def max_value(self):
        return jnp.asarray(1.0)


def inner_product(f, g):
    """∫ f(λ) g(λ) dλ over the dense 1nm grid (Riemann sum, matching
    pbrt InnerProduct semantics)."""
    lam = _DENSE_LAMBDA_J
    return jnp.sum(f(lam) * g(lam))


# ---------------------------------------------------------------------------
# Spectrum → XYZ / photometry
# ---------------------------------------------------------------------------

_CIE_XYZ_J = jnp.stack([jnp.asarray(data.CIE_X), jnp.asarray(data.CIE_Y),
                        jnp.asarray(data.CIE_Z)], axis=0)  # (3, 471)


def cie_xyz_at(lam):
    """(..., S) -> (..., S, 3) CMF values at sampled wavelengths."""
    x = sample_dense(_CIE_XYZ_J[0], lam)
    y = sample_dense(_CIE_XYZ_J[1], lam)
    z = sample_dense(_CIE_XYZ_J[2], lam)
    return jnp.stack([x, y, z], axis=-1)


def sampled_to_xyz(s, wl: SampledWavelengths):
    """MC estimate of the XYZ of a SampledSpectrum (spectrum ToXYZ,
    spectrum.h:175-179): avg over samples of cmf * L / pdf, / integral(Y)."""
    cmf = cie_xyz_at(wl.lam)                      # (..., S, 3)
    w = safe_div(s, wl.pdf)[..., None]            # (..., S, 1)
    return jnp.mean(cmf * w, axis=-2) / CIE_Y_INTEGRAL


def sampled_y(s, wl: SampledWavelengths):
    """Photometric luminance estimate (spectrum y(), spectrum.h:179)."""
    ybar = sample_dense(_CIE_XYZ_J[1], wl.lam)
    return jnp.mean(safe_div(s, wl.pdf) * ybar, axis=-1) / CIE_Y_INTEGRAL


def spectrum_to_xyz(spec):
    """Exact (dense quadrature) XYZ of a spectrum distribution."""
    lam = _DENSE_LAMBDA_J
    v = spec(lam)
    x = jnp.sum(v * _CIE_XYZ_J[0])
    y = jnp.sum(v * _CIE_XYZ_J[1])
    z = jnp.sum(v * _CIE_XYZ_J[2])
    return jnp.stack([x, y, z]) / CIE_Y_INTEGRAL


def spectrum_to_photometric(spec):
    """Luminous output: 683 ∫ ybar(λ) L(λ) dλ (1nm Riemann sum)."""
    lam = _DENSE_LAMBDA_J
    return 683.0 * jnp.sum(spec(lam) * _CIE_XYZ_J[1])
