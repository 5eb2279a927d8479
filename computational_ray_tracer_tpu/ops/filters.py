"""Reconstruction filters with importance sampling.

Capability parity with ``ThirdParty/pbrv4/filters.{h,cpp}`` (Box / Triangle /
Gaussian / LanczosSinc, filters.h:23-296): each filter importance-samples a
pixel offset from ``u ∈ [0,1)^2`` and returns the ``FilterSample{p, weight}``
pattern (filters.h:17-21) with ``weight = f(p) / pdf(p)``.

array-first: box/triangle/gaussian sample *analytically* — closed-form inverse
CDFs (erfinv for the Gaussian), pure elementwise math with no table
gathers in the per-sample hot path. Only the windowed sinc (negative lobes,
no closed form) uses a small tabulated inverse CDF.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import jax
import jax.numpy as jnp

from computational_ray_tracer_tpu.ops import sampling as smp


@dataclasses.dataclass(frozen=True)
class Filter:
    """A separable reconstruction filter.

    ``sample(u2) -> (p, weight)``: offset in [-rx, rx] x [-ry, ry] and the
    importance weight f(p)/pdf(p). ``evaluate(p)`` gives f(p) for arbitrary
    offsets (filters.h Evaluate).
    """
    name: str
    radius: tuple
    integral: float
    _sample_axis_x: Callable    # u -> (x, f1d(x)/pdf1d(x))
    _sample_axis_y: Callable
    _eval_axis_x: Callable      # x -> f1d(x)
    _eval_axis_y: Callable

    def sample(self, u2):
        px, wx = self._sample_axis_x(u2[..., 0])
        py, wy = self._sample_axis_y(u2[..., 1])
        return jnp.stack([px, py], axis=-1), wx * wy

    def evaluate(self, p):
        return self._eval_axis_x(p[..., 0]) * self._eval_axis_y(p[..., 1])


def box_filter(radius=(0.5, 0.5)):
    """Uniform box (filters.h:66-93): exact analytic sampling."""
    rx, ry = radius

    def axis(r):
        def s(u):
            x = (2.0 * u - 1.0) * r
            # f = 1, pdf = 1/(2r) -> weight = 2r per axis
            return x, jnp.full_like(u, 2.0 * r)

        def e(x):
            return jnp.where(jnp.abs(x) <= r, 1.0, 0.0)
        return s, e

    sx, ex = axis(rx)
    sy, ey = axis(ry)
    return Filter("box", radius, 4.0 * rx * ry, sx, sy, ex, ey)


def triangle_filter(radius=(0.5, 0.5)):
    """Tent filter (filters.h:267-296): exact tent inversion per axis."""
    rx, ry = radius

    def axis(r):
        def s(u):
            x = smp.sample_tent(u, r)
            # f(x) = r - |x|; pdf = f / r^2 -> weight = r^2 per axis
            return x, jnp.full_like(u, r * r)

        def e(x):
            return jnp.maximum(0.0, r - jnp.abs(x))
        return s, e

    sx, ex = axis(rx)
    sy, ey = axis(ry)
    return Filter("triangle", radius, rx * rx * ry * ry, sx, sy, ex, ey)


def gaussian_filter(radius=(1.5, 1.5), sigma=0.5):
    """Clipped Gaussian f(x) = g(x) - g(r) (filters.h:96-161).

    Sampled by the *truncated Gaussian* via erfinv (exact, analytic); the
    clip offset is folded into the importance weight f/pdf (still exactly
    unbiased — weight is no longer constant, which the estimator handles).
    """
    s2 = math.sqrt(2.0) * sigma

    def g(x, r):
        return jnp.exp(-(x * x) / (2 * sigma * sigma)) - math.exp(
            -(r * r) / (2 * sigma * sigma))

    def axis(r):
        # CDF of the (unclipped) Gaussian at +-r
        cdf_r = 0.5 * (1.0 + math.erf(r / s2))
        cdf_l = 1.0 - cdf_r
        # mass of the truncated gaussian and of the clipped filter
        z_trunc = (cdf_r - cdf_l) * sigma * math.sqrt(2 * math.pi)
        gr = math.exp(-(r * r) / (2 * sigma * sigma))
        integral_f = z_trunc - 2.0 * r * gr  # ∫(g - g(r)) over [-r, r]

        def s(u):
            up = cdf_l + u * (cdf_r - cdf_l)
            x = s2 * smp.erf_inv(2.0 * up - 1.0)
            x = jnp.clip(x, -r, r)
            pdf = jnp.exp(-(x * x) / (2 * sigma * sigma)) / z_trunc
            w = g(x, r) / jnp.maximum(pdf, 1e-12)
            return x, w

        def e(x):
            return jnp.where(jnp.abs(x) <= r, jnp.maximum(g(x, r), 0.0), 0.0)
        return s, e, integral_f

    sx, ex, ix = axis(radius[0])
    sy, ey, iy = axis(radius[1])
    return Filter("gaussian", radius, ix * iy, sx, sy, ex, ey)


def lanczos_sinc_filter(radius=(4.0, 4.0), tau=3.0, n_tab=1024):
    """Windowed sinc (filters.h:216-264): negative lobes, sampled by |f|
    through a compact tabulated inverse CDF with sign-carrying weights."""
    def f1d_np(x, r):
        def sinc(v):
            v = np.abs(v)
            return np.where(v < 1e-5, 1.0, np.sin(math.pi * v) / (math.pi * v))
        return np.where(np.abs(x) <= r, sinc(x) * sinc(x / tau), 0.0)

    def axis(r):
        xs = np.linspace(-r, r, n_tab + 1)
        fx = f1d_np(xs, r)
        absf = np.abs(fx)
        cdf = np.concatenate([[0.0], np.cumsum(0.5 * (absf[1:] + absf[:-1])
                                               * np.diff(xs))])
        total = cdf[-1]
        cdf /= total
        u_grid = np.linspace(0.0, 1.0, n_tab + 1)
        inv = np.interp(u_grid, cdf, xs)
        f_at_inv = np.interp(inv, xs, fx)
        pdf_at_inv = np.interp(inv, xs, absf) / total
        w_grid = jnp.asarray(
            (f_at_inv / np.maximum(pdf_at_inv, 1e-9)).astype(np.float32))
        inv_grid = jnp.asarray(inv.astype(np.float32))
        integral = float(np.trapezoid(fx, xs))
        fx_j = jnp.asarray(fx.astype(np.float32))

        def lookup(grid, u):
            x = jnp.clip(u, 0.0, 1.0) * n_tab
            i = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, n_tab - 1)
            t = x - i
            return grid[i] * (1 - t) + grid[i + 1] * t

        def s(u):
            return lookup(inv_grid, u), lookup(w_grid, u)

        def e(x):
            xx = (jnp.clip(x, -r, r) + r) / (2 * r)
            v = lookup(fx_j, xx)
            return jnp.where(jnp.abs(x) <= r, v, 0.0)
        return s, e, integral

    sx, ex, ix = axis(radius[0])
    sy, ey, iy = axis(radius[1])
    return Filter("lanczos", radius, ix * iy, sx, sy, ex, ey)


FILTERS = {
    "box": box_filter,
    "triangle": triangle_filter,
    "gaussian": gaussian_filter,
    "lanczos": lanczos_sinc_filter,
}
