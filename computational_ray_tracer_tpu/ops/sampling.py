"""Analytic, tabulated, discrete, and rejection samplers.

Capability parity with the reference's sampling library
(``/root/reference/RayTracer/Sampling.h:63-952``), expressed array-first: every
sampler is a *pure function of an explicit uniform* ``u ∈ [0,1)`` (or a pair),
elementwise over arbitrary batch shapes, differentiable where meaningful.
Histogram validation lives in ``tests/test_sampling.py`` (chi-square replaces
the reference's eyeballed Graph2D plots, per SURVEY §4).
"""

from __future__ import annotations

import math
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

INV_PI = 1.0 / math.pi
INV_2PI = 1.0 / (2.0 * math.pi)
INV_4PI = 1.0 / (4.0 * math.pi)
PI_OVER_2 = math.pi / 2.0
PI_OVER_4 = math.pi / 4.0


def erf_inv(x):
    """Inverse error function (polynomial approximation in the style of
    helpers.h:74-104; accurate to ~1e-6 over (-1, 1))."""
    x = jnp.clip(x, -0.99999, 0.99999)
    w = -jnp.log((1.0 - x) * (1.0 + x))

    def small(w):
        w = w - 2.5
        p = 2.81022636e-08
        for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164,
                  0.246640727, 1.50140941):
            p = p * w + c
        return p

    def big(w):
        w = jnp.sqrt(w) - 3.0
        p = -0.000200214257
        for c in (0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047,
                  1.00167406, 2.83297682):
            p = p * w + c
        return p

    return jnp.where(w < 5.0, small(w), big(w)) * x


# ---------------------------------------------------------------------------
# 1D analytic samplers (Sampling.h:188-320)
# ---------------------------------------------------------------------------

def linear_pdf(x, a, b):
    """pdf ∝ lerp(x, a, b) on [0,1] (normalized)."""
    f = a + (b - a) * x
    return jnp.where((x >= 0) & (x <= 1), 2.0 * f / (a + b), 0.0)


def sample_linear(u, a, b):
    """Inverse-CDF sample of the linear pdf on [0,1] (Sampling.h:188-205)."""
    denom = a + jnp.sqrt((1.0 - u) * a * a + u * b * b)
    x = u * (a + b) / jnp.where(denom == 0.0, 1.0, denom)
    return jnp.minimum(x, 0.9999999)


def invert_linear_sample(x, a, b):
    return x * (a * (2.0 - x) + b * x) / (a + b)


def tent_pdf(x, r):
    return jnp.where(jnp.abs(x) < r, 1.0 / r - jnp.abs(x) / (r * r), 0.0)


def sample_tent(u, r):
    """Tent on [-r, r] via two mirrored linear lobes (Sampling.h:221-240):
    left half is an increasing-linear lobe, right half decreasing."""
    lo = u < 0.5
    u_left = jnp.clip(2.0 * u, 0.0, 1.0)
    u_right = jnp.clip(2.0 * u - 1.0, 0.0, 1.0)
    x_left = -r + r * sample_linear(u_left, 0.0, 1.0)
    x_right = r * sample_linear(u_right, 1.0, 0.0)
    return jnp.where(lo, x_left, x_right)


def invert_tent_sample(x, r):
    return jnp.where(
        x <= 0,
        invert_linear_sample(jnp.clip((x + r) / r, 0.0, 1.0), 0.0, 1.0) / 2.0,
        0.5 + invert_linear_sample(jnp.clip(x / r, 0.0, 1.0), 1.0, 0.0) / 2.0)


def exponential_pdf(x, a):
    return jnp.where(x >= 0, a * jnp.exp(-a * x), 0.0)


def sample_exponential(u, a):
    """x = -ln(1-u)/a (Sampling.h:243-254)."""
    return -jnp.log1p(-u) / a


def invert_exponential_sample(x, a):
    return -jnp.expm1(-a * x)


def normal_pdf(x, mu=0.0, sigma=1.0):
    return jnp.exp(-0.5 * ((x - mu) / sigma) ** 2) / (sigma * math.sqrt(2 * math.pi))


def sample_normal(u, mu=0.0, sigma=1.0):
    """Gaussian via ErfInv (Sampling.h:257-268)."""
    return mu + jnp.float32(math.sqrt(2.0)) * sigma * erf_inv(2.0 * u - 1.0)


def invert_normal_sample(x, mu=0.0, sigma=1.0):
    return 0.5 * (1.0 + jax.lax.erf((x - mu) / (sigma * math.sqrt(2.0))))


def logistic_pdf(x, s):
    e = jnp.exp(-jnp.abs(x) / s)
    return e / (s * (1.0 + e) ** 2)


def sample_logistic(u, s):
    return -s * jnp.log(1.0 / u - 1.0)


def invert_logistic_sample(x, s):
    return 1.0 / (1.0 + jnp.exp(-x / s))


# ---------------------------------------------------------------------------
# 2D samplers (Sampling.h:325-480)
# ---------------------------------------------------------------------------

def bilinear_pdf(p, w):
    """pdf of bilinear interpolation weights w = [w00, w10, w01, w11] on
    [0,1]^2 (Sampling.h:325-333)."""
    x, y = p[..., 0], p[..., 1]
    s = w[..., 0] + w[..., 1] + w[..., 2] + w[..., 3]
    f = ((1 - x) * (1 - y) * w[..., 0] + x * (1 - y) * w[..., 1]
         + (1 - x) * y * w[..., 2] + x * y * w[..., 3])
    return jnp.where(s > 0, 4.0 * f / s, 1.0)


def sample_bilinear(u, w):
    """Marginal-then-conditional inversion (Sampling.h:335-352)."""
    y = sample_linear(u[..., 1], w[..., 0] + w[..., 1], w[..., 2] + w[..., 3])
    x = sample_linear(u[..., 0],
                      (1 - y) * w[..., 0] + y * w[..., 2],
                      (1 - y) * w[..., 1] + y * w[..., 3])
    return jnp.stack([x, y], axis=-1)


def invert_bilinear_sample(p, w):
    y = invert_linear_sample(p[..., 1], w[..., 0] + w[..., 1],
                             w[..., 2] + w[..., 3])
    x = invert_linear_sample(p[..., 0],
                             (1 - p[..., 1]) * w[..., 0] + p[..., 1] * w[..., 2],
                             (1 - p[..., 1]) * w[..., 1] + p[..., 1] * w[..., 3])
    return jnp.stack([x, y], axis=-1)


def sample_uniform_disk_polar(u, radius=1.0):
    """r = R√u1, θ = 2π u2 (Sampling.h:355-366)."""
    r = radius * jnp.sqrt(u[..., 0])
    theta = 2.0 * math.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def sample_uniform_disk_concentric(u, radius=1.0):
    """Shirley-Chiu concentric mapping (Sampling.h:385-403) — low distortion,
    used for lens sampling."""
    uo = 2.0 * u - 1.0
    x, y = uo[..., 0], uo[..., 1]
    zero = (x == 0) & (y == 0)
    absx, absy = jnp.abs(x), jnp.abs(y)
    r = jnp.where(absx > absy, x, y)
    safe_div = jnp.where(absx > absy,
                         jnp.where(x != 0, y / jnp.where(x == 0, 1, x), 0.0),
                         jnp.where(y != 0, x / jnp.where(y == 0, 1, y), 0.0))
    theta = jnp.where(absx > absy, PI_OVER_4 * safe_div,
                      PI_OVER_2 - PI_OVER_4 * safe_div)
    p = r[..., None] * jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=-1)
    return jnp.where(zero[..., None], 0.0, radius * p)


def sample_uniform_hemisphere(u):
    """Uniform direction on z>=0 hemisphere (Sampling.h:406-419)."""
    z = u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * math.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_hemisphere_pdf():
    return INV_2PI


def invert_uniform_hemisphere_sample(w):
    phi = jnp.arctan2(w[..., 1], w[..., 0])
    phi = jnp.where(phi < 0, phi + 2 * math.pi, phi)
    return jnp.stack([w[..., 2], phi * INV_2PI], axis=-1)


def sample_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * math.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_sphere_pdf():
    return INV_4PI


def invert_uniform_sphere_sample(w):
    phi = jnp.arctan2(w[..., 1], w[..., 0])
    phi = jnp.where(phi < 0, phi + 2 * math.pi, phi)
    return jnp.stack([(1.0 - w[..., 2]) / 2.0, phi * INV_2PI], axis=-1)


def sample_cosine_hemisphere(u):
    """Malley's method: concentric disk lifted to the hemisphere
    (Sampling.h:449-459)."""
    d = sample_uniform_disk_concentric(u)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - d[..., 0] ** 2 - d[..., 1] ** 2))
    return jnp.concatenate([d, z[..., None]], axis=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def sample_uniform_cone(u, cos_theta_max):
    """Uniform direction inside a cone around +z (Sampling.h:467-480)."""
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta ** 2))
    phi = 2.0 * math.pi * u[..., 1]
    return jnp.stack([sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi),
                      cos_theta], axis=-1)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * math.pi * (1.0 - cos_theta_max))


# ---------------------------------------------------------------------------
# Discrete sampling (Sampling.h:76-182) and alias tables (Sampling.h:905-952)
# ---------------------------------------------------------------------------

def sample_discrete(u, weights):
    """Inverse-CDF over unnormalized weights (..., K) -> (index, pmf, u_remap).

    The remapped u reuses the residual uniform (PBRT SampleDiscrete
    semantics)."""
    w = jnp.asarray(weights)
    cdf = jnp.cumsum(w, axis=-1)
    total = cdf[..., -1:]
    cdf = cdf / total
    up = u[..., None] if jnp.ndim(u) < jnp.ndim(cdf) else u
    idx = jnp.sum((up >= cdf).astype(jnp.int32), axis=-1)
    idx = jnp.clip(idx, 0, w.shape[-1] - 1)
    pmf = jnp.take_along_axis(w / total, idx[..., None], axis=-1)[..., 0]
    lo = jnp.where(idx > 0,
                   jnp.take_along_axis(cdf, jnp.maximum(idx - 1, 0)[..., None],
                                       axis=-1)[..., 0], 0.0)
    hi = jnp.take_along_axis(cdf, idx[..., None], axis=-1)[..., 0]
    u_remap = jnp.clip((jnp.squeeze(up, -1) - lo) / jnp.maximum(hi - lo, 1e-12),
                       0.0, 1.0)
    return idx, pmf, u_remap


@dataclasses.dataclass(frozen=True)
class AliasTable:
    """Vose alias method. The reference declares but never implements Sample
    (Sampling.h:905-952) — here it is complete: O(1) branch-free device
    sampling from host-built tables."""
    q: jnp.ndarray        # (K,) acceptance thresholds
    alias: jnp.ndarray    # (K,) alias indices
    pmf: jnp.ndarray      # (K,) normalized pmf

    @classmethod
    def build(cls, weights):
        w = np.asarray(weights, dtype=np.float64)
        pmf = w / w.sum()
        k = len(w)
        q = pmf * k
        alias = np.arange(k)
        small = [i for i in range(k) if q[i] < 1.0]
        large = [i for i in range(k) if q[i] >= 1.0]
        q = q.copy()
        while small and large:
            s, l = small.pop(), large.pop()
            alias[s] = l
            q[l] = (q[l] + q[s]) - 1.0
            (small if q[l] < 1.0 else large).append(l)
        return cls(jnp.asarray(q, dtype=jnp.float32),
                   jnp.asarray(alias, dtype=jnp.int32),
                   jnp.asarray(pmf, dtype=jnp.float32))

    def sample(self, u):
        k = self.q.shape[0]
        scaled = u * k
        idx = jnp.clip(scaled.astype(jnp.int32), 0, k - 1)
        frac = scaled - idx.astype(u.dtype)
        take_alias = frac >= self.q[idx]
        out = jnp.where(take_alias, self.alias[idx], idx)
        return out, self.pmf[out]


# ---------------------------------------------------------------------------
# Generic pdf utilities & tabulated inversion (Sampling.h:485-902)
# ---------------------------------------------------------------------------

def normalize_pdf(f, a, b, n=8192):
    """Riemann normalization constant of f over [a, b] (Sampling.h:485-502)."""
    x = jnp.linspace(a, b, n)
    return jnp.trapezoid(f(x), x)


@dataclasses.dataclass(frozen=True)
class TabulatedDistribution1D:
    """Continuous inversion sampler from a tabulated pdf
    (Continuous_Inversion_Sampler, Sampling.h:781-902): CDF table +
    linear-interp inversion, vectorized with searchsorted."""
    x: jnp.ndarray      # (N,) support nodes
    pdf: jnp.ndarray    # (N,) normalized density at nodes
    cdf: jnp.ndarray    # (N,)

    @classmethod
    def from_function(cls, f, a, b, n=1024):
        x = np.linspace(a, b, n)
        fx = np.maximum(np.asarray(f(jnp.asarray(x))), 0.0)
        cdf = np.concatenate([[0.0], np.cumsum(0.5 * (fx[1:] + fx[:-1])
                                               * np.diff(x))])
        total = cdf[-1]
        return cls(jnp.asarray(x, dtype=jnp.float32),
                   jnp.asarray(fx / total, dtype=jnp.float32),
                   jnp.asarray(cdf / total, dtype=jnp.float32))

    @classmethod
    def from_table(cls, x, fx):
        x = np.asarray(x, dtype=np.float64)
        fx = np.maximum(np.asarray(fx, dtype=np.float64), 0.0)
        cdf = np.concatenate([[0.0], np.cumsum(0.5 * (fx[1:] + fx[:-1])
                                               * np.diff(x))])
        total = cdf[-1]
        return cls(jnp.asarray(x, dtype=jnp.float32),
                   jnp.asarray(fx / total, dtype=jnp.float32),
                   jnp.asarray(cdf / total, dtype=jnp.float32))

    def sample(self, u):
        i = jnp.clip(jnp.searchsorted(self.cdf, u, side="right") - 1,
                     0, self.x.shape[0] - 2)
        c0, c1 = self.cdf[i], self.cdf[i + 1]
        t = (u - c0) / jnp.maximum(c1 - c0, 1e-12)
        xs = self.x[i] + t * (self.x[i + 1] - self.x[i])
        p = self.pdf[i] + t * (self.pdf[i + 1] - self.pdf[i])
        return xs, p

    def pdf_at(self, xq):
        i = jnp.clip(jnp.searchsorted(self.x, xq, side="right") - 1,
                     0, self.x.shape[0] - 2)
        t = (xq - self.x[i]) / jnp.maximum(self.x[i + 1] - self.x[i], 1e-12)
        return self.pdf[i] + jnp.clip(t, 0, 1) * (self.pdf[i + 1] - self.pdf[i])


def rejection_sample_1d(f, key, a, b, f_max, n, oversample=4):
    """Fixed-budget vectorized rejection sampling over [a,b]
    (Sampling.h:601-644 capability): draw `oversample*n` candidates, keep
    accepted ones, fill to exactly n by resampling accepted indices."""
    k1, k2, k3 = jax.random.split(key, 3)
    m = oversample * n
    x = jax.random.uniform(k1, (m,), minval=a, maxval=b)
    y = jax.random.uniform(k2, (m,), minval=0.0, maxval=f_max)
    accept = y < f(x)
    # Gather accepted values; duplicate to fill (statistically fine since
    # accepted draws are iid from the target).
    idx = jnp.argsort(~accept)  # accepted first, stable
    n_acc = jnp.sum(accept)
    pick = jax.random.randint(k3, (n,), 0, jnp.maximum(n_acc, 1))
    return x[idx[pick]]


# ---------------------------------------------------------------------------
# Histogram validation helpers (Sampling.h:553-598, 681-777)
# ---------------------------------------------------------------------------

def histogram_pdf(samples, a, b, bins=64):
    """Normalized histogram (density estimate) of samples over [a, b]."""
    h, edges = jnp.histogram(samples, bins=bins, range=(a, b))
    width = (b - a) / bins
    dens = h.astype(jnp.float32) / (samples.shape[0] * width)
    centers = (edges[:-1] + edges[1:]) / 2.0
    return centers, dens


def chi_square_statistic(samples, cdf, a, b, bins=32):
    """Chi-square GOF statistic of samples vs an analytic CDF."""
    h, edges = np.histogram(np.asarray(samples), bins=bins, range=(a, b))
    n = len(np.asarray(samples))
    expected = np.diff([float(cdf(e)) for e in edges]) * n
    mask = expected > 5
    return float(np.sum((h[mask] - expected[mask]) ** 2 / expected[mask])), int(mask.sum())
