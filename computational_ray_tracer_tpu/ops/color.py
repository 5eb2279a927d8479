"""Color science: XYZ/RGB, color spaces, white balance, RGB↔spectral.

Capability parity with the reference's ``ThirdParty/pbrv4/color.{h,cpp}`` and
``colorspace.{h,cpp}``, array-first:

- colors are plain jnp ``(..., 3)`` arrays; conversions are 3x3 matmuls that
  XLA fuses into surrounding element-wise work.
- ``RGBSigmoidPolynomial`` (color.h:363-403) is a closed-form function of 3
  coefficients per color.
- The reference loads a 64^3 binary coefficient table from disk at startup
  (color.cpp:107-166, a file absent from its repo). We instead *solve* the
  Jakob-Hanika fit directly: a vmapped, jitted Levenberg-Marquardt over the
  spectral round-trip runs on the device itself, both on demand (per material)
  and to generate a cached coefficient table.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from computational_ray_tracer_tpu.ops import spectra_data as data
from computational_ray_tracer_tpu.ops import spectrum as spec


# ---------------------------------------------------------------------------
# Chromaticity / XYZ (color.h:17-359)
# ---------------------------------------------------------------------------

def xyY_to_xyz(xy, Y=1.0):
    """XYZ from chromaticity (x, y) and luminance Y (XYZ::FromxyY)."""
    x, y = xy[..., 0], xy[..., 1]
    Y = jnp.asarray(Y)
    safe = y != 0.0
    ys = jnp.where(safe, y, 1.0)
    X = jnp.where(safe, x * Y / ys, 0.0)
    Z = jnp.where(safe, (1.0 - x - y) * Y / ys, 0.0)
    return jnp.stack([X, jnp.where(safe, Y, 0.0), Z], axis=-1)


def xyz_chromaticity(xyz):
    """(x, y) of an XYZ triple (XYZ::xy())."""
    s = jnp.sum(xyz, axis=-1, keepdims=True)
    return xyz[..., :2] / s


# ---------------------------------------------------------------------------
# Color spaces (colorspace.h:18-75)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RGBColorSpace:
    """An RGB color space from primary + whitepoint chromaticities.

    Matrices are derived analytically (host-side numpy, float64) exactly as
    colorspace.cpp:21-60 does: scale primary XYZ columns so RGB(1,1,1) maps to
    the whitepoint.
    """
    name: str
    r: tuple
    g: tuple
    b: tuple
    w: tuple
    xyz_from_rgb: np.ndarray
    rgb_from_xyz: np.ndarray
    illuminant: np.ndarray  # dense (471,) SPD of the whitepoint illuminant

    @classmethod
    def create(cls, name, r, g, b, w, illuminant):
        def xyY(xy):
            x, y = xy
            return np.array([x / y, 1.0, (1 - x - y) / y], dtype=np.float64)
        R, G, B, W = xyY(r), xyY(g), xyY(b), xyY(w)
        M = np.stack([R, G, B], axis=1)
        s = np.linalg.solve(M, W)
        xyz_from_rgb = M * s[None, :]
        return cls(name, r, g, b, w,
                   xyz_from_rgb.astype(np.float64),
                   np.linalg.inv(xyz_from_rgb).astype(np.float64),
                   np.asarray(illuminant, dtype=np.float32))

    def to_rgb(self, xyz):
        m = jnp.asarray(self.rgb_from_xyz, dtype=jnp.float32)
        return jnp.einsum("ij,...j->...i", m, xyz, precision="highest")

    def to_xyz(self, rgb):
        m = jnp.asarray(self.xyz_from_rgb, dtype=jnp.float32)
        return jnp.einsum("ij,...j->...i", m, rgb, precision="highest")


SRGB = RGBColorSpace.create(
    "sRGB", (0.64, 0.33), (0.30, 0.60), (0.15, 0.06), (0.3127, 0.3290),
    data.ILLUM_D65)
DCI_P3 = RGBColorSpace.create(
    "DCI-P3", (0.680, 0.320), (0.265, 0.690), (0.150, 0.060), (0.314, 0.351),
    data.ILLUM_D65)
REC_2020 = RGBColorSpace.create(
    "Rec2020", (0.708, 0.292), (0.170, 0.797), (0.131, 0.046), (0.3127, 0.3290),
    data.ILLUM_D65)
ACES2065_1 = RGBColorSpace.create(
    "ACES2065-1", (0.7347, 0.2653), (0.0, 1.0), (0.0001, -0.077),
    (0.32168, 0.33767), data.ILLUM_D60)

COLOR_SPACES = {cs.name: cs for cs in (SRGB, DCI_P3, REC_2020, ACES2065_1)}


def convert_rgb_colorspace(rgb, src: RGBColorSpace, dst: RGBColorSpace):
    """ConvertRGBColorSpace (colorspace.h:75)."""
    m = jnp.asarray(dst.rgb_from_xyz @ src.xyz_from_rgb, dtype=jnp.float32)
    return jnp.einsum("ij,...j->...i", m, rgb, precision="highest")


# ---------------------------------------------------------------------------
# White balance (Bradford chromatic adaptation; color.h:603-628)
# ---------------------------------------------------------------------------

_LMS_FROM_XYZ = np.array([
    [0.8951, 0.2664, -0.1614],
    [-0.7502, 1.7135, 0.0367],
    [0.0389, -0.0685, 1.0296]], dtype=np.float64)
_XYZ_FROM_LMS = np.linalg.inv(_LMS_FROM_XYZ)


def white_balance_matrix(src_xy, dst_xy):
    """3x3 XYZ->XYZ Bradford adaptation from src whitepoint to dst."""
    src = np.asarray(xyY_to_xyz(jnp.asarray(src_xy, dtype=jnp.float64)))
    dst = np.asarray(xyY_to_xyz(jnp.asarray(dst_xy, dtype=jnp.float64)))
    lms_s = _LMS_FROM_XYZ @ src
    lms_d = _LMS_FROM_XYZ @ dst
    scale = np.diag(lms_d / lms_s)
    return (_XYZ_FROM_LMS @ scale @ _LMS_FROM_XYZ).astype(np.float32)


# ---------------------------------------------------------------------------
# sRGB transfer function
# ---------------------------------------------------------------------------

def linear_to_srgb(c):
    c = jnp.clip(c, 0.0, 1.0)
    return jnp.where(c <= 0.0031308, 12.92 * c,
                     1.055 * jnp.power(jnp.maximum(c, 1e-7), 1.0 / 2.4) - 0.055)


def srgb_to_linear(c):
    return jnp.where(c <= 0.04045, c / 12.92,
                     jnp.power((c + 0.055) / 1.055, 2.4))


# ---------------------------------------------------------------------------
# RGBSigmoidPolynomial (color.h:363-403)
# ---------------------------------------------------------------------------

def _sigmoid(x):
    return 0.5 + x / (2.0 * jnp.sqrt(1.0 + x * x))


def _lam_norm(lam):
    """Map [360, 830] -> [-1, 1] for polynomial conditioning."""
    return (lam - spec.LAMBDA_MIN) / (spec.LAMBDA_MAX - spec.LAMBDA_MIN) * 2.0 - 1.0


def sigmoid_polynomial(coeffs, lam):
    """Reflectance in [0,1]: s(c2 t^2 + c1 t + c0) with t the normalized
    wavelength.

    Shape convention: ``coeffs`` is (..., 3) and ``lam`` is (..., L) where
    coeffs' batch dims broadcast against lam's batch dims (lam carries one
    extra trailing wavelength axis). E.g. (3,) x (L,), or (N, 3) x (N, S).
    """
    t = _lam_norm(lam)
    c0 = coeffs[..., 0:1]
    c1 = coeffs[..., 1:2]
    c2 = coeffs[..., 2:3]
    p = (c2 * t + c1) * t + c0
    return _sigmoid(p)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class RGBAlbedoSpectrum:
    """Bounded reflectance spectrum from sigmoid-polynomial coefficients
    (spectrum.h:535-566)."""
    coeffs: jnp.ndarray  # (..., 3)

    def tree_flatten(self):
        return (self.coeffs,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def from_rgb(cls, rgb, colorspace=None):
        return cls(fit_rgb_to_spectrum(jnp.asarray(rgb, dtype=jnp.float32),
                                       colorspace or SRGB))

    def __call__(self, lam):
        return sigmoid_polynomial(self.coeffs, lam)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class RGBUnboundedSpectrum:
    """Scaled sigmoid spectrum for RGB outside [0,1] (spectrum.h:568-599)."""
    coeffs: jnp.ndarray
    scale: jnp.ndarray

    def tree_flatten(self):
        return (self.coeffs, self.scale), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def from_rgb(cls, rgb, colorspace=None):
        rgb = jnp.asarray(rgb, dtype=jnp.float32)
        m = jnp.maximum(jnp.max(rgb, axis=-1), 1e-6)
        scale = 2.0 * m
        coeffs = fit_rgb_to_spectrum(rgb / scale[..., None], colorspace or SRGB)
        return cls(coeffs, scale)

    def __call__(self, lam):
        s = self.scale[..., None] if jnp.ndim(self.scale) else self.scale
        return s * sigmoid_polynomial(self.coeffs, lam)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class RGBIlluminantSpectrum:
    """Illuminant-shaped emission spectrum for an RGB color
    (spectrum.h:601-638): scaled reflectance fit times the space's illuminant."""
    coeffs: jnp.ndarray
    scale: jnp.ndarray
    illuminant: jnp.ndarray  # dense (471,)

    def tree_flatten(self):
        return (self.coeffs, self.scale, self.illuminant), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def from_rgb(cls, rgb, colorspace=None):
        cs = colorspace or SRGB
        rgb = jnp.asarray(rgb, dtype=jnp.float32)
        m = jnp.maximum(jnp.max(rgb, axis=-1), 1e-6)
        scale = 2.0 * m
        coeffs = fit_rgb_to_spectrum(rgb / scale[..., None], cs)
        return cls(coeffs, scale, jnp.asarray(cs.illuminant))

    def __call__(self, lam):
        s = self.scale[..., None] if jnp.ndim(self.scale) else self.scale
        return (s * sigmoid_polynomial(self.coeffs, lam)
                * spec.sample_dense(self.illuminant, lam))


# ---------------------------------------------------------------------------
# The rgb2spec solve (replaces the reference's external 64^3 binary table)
# ---------------------------------------------------------------------------

# Quadrature grid for the fit (5nm — 95 points is plenty for smooth sigmoids).
_FIT_LAM = jnp.asarray(np.arange(360.0, 831.0, 5.0, dtype=np.float32))


def _roundtrip_rgb(coeffs, rgb_from_xyz, illum_w, cmf_w):
    """RGB of reflectance sigmoid(coeffs) under the fit illuminant."""
    r = sigmoid_polynomial(coeffs, _FIT_LAM)          # (..., L)
    xyz = jnp.einsum("...l,cl->...c", r * illum_w, cmf_w, precision="highest")
    return jnp.einsum("ij,...j->...i", rgb_from_xyz, xyz,
                      precision="highest")


def _fit_tables(colorspace):
    lamf = np.asarray(_FIT_LAM)
    illum = np.interp(lamf, data.DENSE_LAMBDA, colorspace.illuminant)
    cmf = np.stack([
        np.interp(lamf, data.DENSE_LAMBDA, data.CIE_X),
        np.interp(lamf, data.DENSE_LAMBDA, data.CIE_Y),
        np.interp(lamf, data.DENSE_LAMBDA, data.CIE_Z)])
    # Normalize so a perfect reflector maps to the whitepoint with Y = 1.
    norm = 1.0 / np.sum(illum * cmf[1])
    cmf_w = jnp.asarray((cmf * norm).astype(np.float32))
    return jnp.asarray(illum.astype(np.float32)), cmf_w, jnp.asarray(
        colorspace.rgb_from_xyz.astype(np.float32))


def _lm_fit(rgb, illum_w, cmf_w, rgb_from_xyz, n_iter=40):
    """Levenberg-Marquardt on the 3-residual round-trip. Vectorized over
    leading dims of rgb via vmap by the caller."""
    def resid(c):
        return _roundtrip_rgb(c, rgb_from_xyz, illum_w, cmf_w) - rgb

    def step(carry, _):
        c, lm = carry
        r = resid(c)
        J = jax.jacfwd(resid)(c)
        A = (jnp.matmul(J.T, J, precision="highest")
             + lm * jnp.eye(3, dtype=c.dtype))
        delta = jnp.linalg.solve(A, jnp.matmul(J.T, r, precision="highest"))
        c_new = c - delta
        better = jnp.sum(resid(c_new) ** 2) < jnp.sum(r ** 2)
        c = jnp.where(better, c_new, c)
        lm = jnp.where(better, lm * 0.5, lm * 4.0)
        return (c, jnp.clip(lm, 1e-8, 1e4)), None

    # Init: flat spectrum at the target luminance.
    y = jnp.clip(jnp.sum(rgb) / 3.0, 1e-4, 1.0 - 1e-4)
    c0 = jnp.array([jnp.log(y / (1.0 - y)), 0.0, 0.0], dtype=jnp.float32)
    (c, _), _ = jax.lax.scan(step, (c0, jnp.float32(1e-2)), None, length=n_iter)
    return c


@jax.jit
def _fit_srgb(rgb_flat):
    illum_w, cmf_w, m = _fit_tables(SRGB)
    return jax.vmap(lambda x: _lm_fit(x, illum_w, cmf_w, m))(rgb_flat)


_FIT_CACHE = {}


def fit_rgb_to_spectrum(rgb, colorspace=None):
    """Sigmoid-polynomial coefficients (..., 3) for RGB reflectances (..., 3).

    Runs a jitted vmapped LM solve. This is *scene-setup* work (one-shot, per
    material/texture), so it is pinned to the host CPU backend — render-time
    code only ever evaluates the resulting polynomial.
    """
    cs = colorspace or SRGB
    rgb = jnp.asarray(rgb, dtype=jnp.float32)
    shape = rgb.shape
    with jax.default_device(jax.devices("cpu")[0]):
        flat = jnp.asarray(np.asarray(rgb).reshape(-1, 3))
        if cs.name == "sRGB":
            out = _fit_srgb(flat)
        else:
            if cs.name not in _FIT_CACHE:
                tables = _fit_tables(cs)

                @jax.jit
                def _fit(rgb_flat, tables=tables):
                    illum_w, cmf_w, m = tables
                    return jax.vmap(
                        lambda x: _lm_fit(x, illum_w, cmf_w, m))(rgb_flat)
                _FIT_CACHE[cs.name] = _fit
            out = _FIT_CACHE[cs.name](flat)
        out = np.asarray(out)
    return jnp.asarray(out).reshape(shape)


# ---------------------------------------------------------------------------
# RGBToSpectrumTable: precomputed coefficient grid (color.h:407-433)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RGBToSpectrumTable:
    """A (res, res, res, 3) coefficient grid over RGB, trilinearly
    interpolated at lookup. Regenerated on device (vs the reference's
    disk-loaded 64^3 binary, color.cpp:107-166) and cached as .npy."""
    res: int
    coeffs: jnp.ndarray  # (res, res, res, 3)

    @classmethod
    def srgb(cls):
        """The shipped 64^3 sRGB table (same resolution as the reference's
        sRGB64binary, color.cpp:114 — which was NOT committed there and broke
        at startup; ours is in-package). Cached per process."""
        if "srgb64" not in _FIT_CACHE:
            import os
            path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "data", "rgb2spec_srgb_64.npy")
            _FIT_CACHE["srgb64"] = cls.generate(res=64, cache_path=path)
        return _FIT_CACHE["srgb64"]

    @classmethod
    def generate(cls, res=32, colorspace=None, cache_path=None):
        import os
        cs = colorspace or SRGB
        if cache_path and os.path.exists(cache_path):
            return cls(res, jnp.asarray(np.load(cache_path)))
        g = (np.arange(res, dtype=np.float32) + 0.5) / res
        grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1)
        coeffs = np.asarray(fit_rgb_to_spectrum(jnp.asarray(grid), cs))
        if cache_path:
            np.save(cache_path, coeffs)
        return cls(res, jnp.asarray(coeffs))

    def lookup(self, rgb):
        """Trilinear interpolation of coefficients at rgb in [0,1]^3."""
        r = self.res
        x = jnp.clip(rgb, 0.0, 1.0) * r - 0.5
        i0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, r - 2)
        w = jnp.clip(x - i0, 0.0, 1.0)

        def gather(ix, iy, iz):
            return self.coeffs[ix, iy, iz]

        c = 0.0
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    wt = (jnp.where(dx, w[..., 0], 1 - w[..., 0])
                          * jnp.where(dy, w[..., 1], 1 - w[..., 1])
                          * jnp.where(dz, w[..., 2], 1 - w[..., 2]))
                    c = c + wt[..., None] * gather(i0[..., 0] + dx,
                                                   i0[..., 1] + dy,
                                                   i0[..., 2] + dz)
        return c
