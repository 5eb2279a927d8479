"""Numeric substrate helpers (capability of ``ThirdParty/pbrv4/helpers.h``).

The reference's L0 numeric toolkit — compensated arithmetic, FP error
bounds, polynomial evaluation, branchless interval search, Gaussian/sinc
kernels, and tiny least-squares — re-expressed as elementwise jnp functions
that batch over arbitrary shapes. Several of these already live
inline next to their single caller (``ops/shapes.py`` has
``fp_gamma``/``difference_of_products``; ``ops/sampling.py`` has
``erf_inv``); this module is the explicit public surface and adds the
pieces with no inline home.

Reference citations:
- CompensatedFloat / TwoProd / TwoSum  — helpers.h:11,180-190
- gamma(n)                             — helpers.h:52
- DifferenceOfProducts                 — helpers.h:56-62
- ErfInv                               — helpers.h:74-104
- EvaluatePolynomial (Horner)          — helpers.h:117-126
- FindInterval (branchless bisect)     — helpers.h:159-172
- Gaussian / GaussianIntegral          — helpers.h:221-233
- Sinc / WindowedSinc                  — helpers.h:235-252
- LinearLeastSquares (normal eqs)      — helpers.h:257-274
"""

from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp

# Re-exported canonical implementations (single source of truth).
from computational_ray_tracer_tpu.ops.shapes import (  # noqa: F401
    fp_gamma, difference_of_products, MACHINE_EPS)
from computational_ray_tracer_tpu.ops.sampling import erf_inv  # noqa: F401


def two_prod(a, b):
    """(a*b, rounding error) via Dekker splitting (TwoProd, helpers.h:180).
    Exact: a*b == prod + err in real arithmetic."""
    ab = a * b
    c = jnp.float32(0x10001) * a
    ah = c - (c - a)
    al = a - ah
    c = jnp.float32(0x10001) * b
    bh = c - (c - b)
    bl = b - bh
    err = ((ah * bh - ab) + ah * bl + al * bh) + al * bl
    return ab, err


def two_sum(a, b):
    """(a+b, rounding error) — Knuth's branch-free TwoSum (helpers.h:186)."""
    s = a + b
    delta = s - a
    err = (a - (s - delta)) + (b - delta)
    return s, err


def compensated_sum(values, axis=-1):
    """Kahan-compensated reduction along ``axis`` (CompensatedFloat
    accumulation pattern, helpers.h:11-50) — tighter than a plain jnp.sum
    for long low-magnitude tails."""
    values = jnp.moveaxis(jnp.asarray(values), axis, 0)
    s = jnp.zeros_like(values[0])
    c = jnp.zeros_like(values[0])
    for i in range(values.shape[0]):
        y = values[i] - c
        t = s + y
        c = (t - s) - y
        s = t
    return s


def evaluate_polynomial(t, *coeffs):
    """Horner evaluation: coeffs c0 + c1 t + c2 t^2 + ... (helpers.h:117)."""
    r = jnp.zeros_like(jnp.asarray(t, jnp.float32)) + jnp.float32(coeffs[-1])
    for c in reversed(coeffs[:-1]):
        r = r * t + jnp.float32(c)
    return r


def find_interval(values, x):
    """Largest index i with values[i] <= x, clamped to [0, n-2]
    (FindInterval, helpers.h:159-172): the bracketing-interval lookup used
    by every tabulated-CDF/LUT interpolation. Branchless on device via
    searchsorted (log2 n compare-selects)."""
    values = jnp.asarray(values)
    i = jnp.searchsorted(values, x, side="right") - 1
    return jnp.clip(i, 0, values.shape[0] - 2)


def gaussian(x, mu=0.0, sigma=1.0):
    """Normalized Gaussian pdf (helpers.h:221-226)."""
    inv = 1.0 / (jnp.float32(math.sqrt(2.0 * math.pi)) * sigma)
    z = (x - mu) / sigma
    return inv * jnp.exp(-0.5 * z * z)


def gaussian_integral(x0, x1, mu=0.0, sigma=1.0):
    """∫ gaussian on [x0, x1] via erf (helpers.h:228-233)."""
    s = sigma * jnp.float32(math.sqrt(2.0))
    from jax.scipy.special import erf
    return 0.5 * (erf((x1 - mu) / s) - erf((x0 - mu) / s))


def sinc(x):
    """Normalized sinc sin(pi x)/(pi x) (helpers.h:235-241)."""
    x = jnp.asarray(x, jnp.float32)
    small = jnp.abs(x) < 1e-5
    xs = jnp.where(small, 1.0, x)  # keep grad finite
    return jnp.where(small, 1.0, jnp.sin(jnp.pi * xs) / (jnp.pi * xs))


def windowed_sinc(x, radius, tau):
    """Lanczos-windowed sinc (WindowedSinc, helpers.h:243-252)."""
    x = jnp.asarray(x, jnp.float32)
    return jnp.where(jnp.abs(x) > radius, 0.0, sinc(x) * sinc(x / tau))


def linear_least_squares(A, B):
    """Least-squares X minimizing ||A @ X - B|| via the normal equations
    (LinearLeastSquares, helpers.h:257-274 — there fixed 3x3, here any
    (n, k) @ (k, m)). Host-or-device; tiny systems only."""
    A = jnp.asarray(A, jnp.float32)
    B = jnp.asarray(B, jnp.float32)
    AtA = jnp.matmul(A.T, A, precision="highest")
    AtB = jnp.matmul(A.T, B, precision="highest")
    return jnp.linalg.solve(AtA, AtB)


# ---------------------------------------------------------------------------
# Clamped small-table row select
# ---------------------------------------------------------------------------

def select_rows(tab, idx):
    """``tab[idx]`` with out-of-range ``idx`` CLAMPED to [0, M) (a raw jnp
    gather would wrap negative indices); callers passing sentinel rows must
    mask the result."""
    m = tab.shape[0]
    if m > 0:
        idx = jnp.clip(idx, 0, m - 1)
    return tab[idx]
