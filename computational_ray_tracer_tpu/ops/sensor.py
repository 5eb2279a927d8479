"""Camera pixel sensor model.

Capability parity with ``ThirdParty/pbrv4/pixelsensor.{h,cpp}``:
spectral radiance → sensor RGB via r̄/ḡ/b̄ response curves, then sensor RGB →
XYZ through a 3x3 matrix solved by linear least squares over the 24
ColorChecker swatches under the sensor illuminant (pixelsensor.h:37-87).

array-first: all calibration (the least-squares solve) happens host-side at
sensor construction in float64; the per-sample ``to_sensor_rgb`` is one fused
gather+mean over the 8-wavelength axis on device.

Calibration uses the measured BabelColor ColorChecker swatch reflectances
(the dataset behind pixelsensor.cpp:244-270, shipped dense in
``data/spectra_tables.npz``). A sigmoid-polynomial synthesis path from the
published sRGB patch values is kept as an independent oracle
(`macbeth_reflectances(synthetic=True)`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from computational_ray_tracer_tpu.ops import spectra_data as data
from computational_ray_tracer_tpu.ops import spectrum as spec
from computational_ray_tracer_tpu.ops import color as colorlib


# Classic X-Rite ColorChecker 24 patch sRGB values (8-bit).
MACBETH_SRGB = np.array([
    [115, 82, 68], [194, 150, 130], [98, 122, 157], [87, 108, 67],
    [133, 128, 177], [103, 189, 170], [214, 126, 44], [80, 91, 166],
    [193, 90, 99], [94, 60, 108], [157, 188, 64], [224, 163, 46],
    [56, 61, 150], [70, 148, 73], [175, 54, 60], [231, 199, 31],
    [187, 86, 149], [8, 133, 161], [243, 243, 242], [200, 200, 200],
    [160, 160, 160], [122, 122, 122], [85, 85, 85], [52, 52, 52],
], dtype=np.float64) / 255.0

_SWATCH_CACHE = {}


def macbeth_reflectances(synthetic=False):
    """(24, 471) dense reflectance spectra of the ColorChecker patches.

    Default: the measured BabelColor dataset. `synthetic=True` upsamples the
    published sRGB patch values through the rgb2spec fit instead (oracle)."""
    if not synthetic:
        return np.asarray(data.MACBETH_SWATCHES, dtype=np.float64)
    if "swatches" not in _SWATCH_CACHE:
        lin = np.asarray(colorlib.srgb_to_linear(jnp.asarray(MACBETH_SRGB)))
        coeffs = colorlib.fit_rgb_to_spectrum(jnp.asarray(lin, jnp.float32))
        lam = jnp.asarray(data.DENSE_LAMBDA, jnp.float32)
        refl = colorlib.sigmoid_polynomial(
            coeffs, jnp.broadcast_to(lam, (24, lam.shape[0])))
        _SWATCH_CACHE["swatches"] = np.asarray(refl, dtype=np.float64)
    return _SWATCH_CACHE["swatches"]


def _project_reflectance(refl, illum, b1, b2, b3):
    """∫ refl·illum·b̄_c dλ for three response curves, normalized so that a
    perfect reflector has second channel 1 (ProjectReflectance,
    pixelsensor.h:105-118)."""
    out = np.stack([
        np.sum(refl * illum * b1, axis=-1),
        np.sum(refl * illum * b2, axis=-1),
        np.sum(refl * illum * b3, axis=-1)], axis=-1)
    norm = np.sum(illum * b2)
    return out / norm


@dataclasses.dataclass(frozen=True)
class PixelSensor:
    """Sensor response + calibrated XYZ conversion.

    ``to_sensor_rgb(L, wl)`` computes imaging_ratio · mean_λ(b̄(λ)·L/pdf)
    (pixelsensor.h:81-87); ``xyz_from_sensor_rgb`` is the calibrated 3x3.
    """
    curves: jnp.ndarray            # (3, 471) r̄/ḡ/b̄
    xyz_from_sensor_rgb: np.ndarray  # (3, 3) float
    imaging_ratio: float

    @classmethod
    def create(cls, sensor_name=None, colorspace=None, sensor_illum=None,
               imaging_ratio=1.0):
        """`sensor_name=None` gives the default XYZ-matching sensor
        (pixelsensor.h:70-79): curves are the CIE CMFs and the matrix is a
        white-balance from the sensor illuminant to the space's whitepoint."""
        cs = colorspace or colorlib.SRGB
        if sensor_name is None:
            curves = np.stack([data.CIE_X, data.CIE_Y, data.CIE_Z]).astype(np.float64)
            if sensor_illum is not None:
                src_xyz = _illum_xyz(sensor_illum)
                src_xy = src_xyz[:2] / src_xyz.sum()
                m = colorlib.white_balance_matrix(tuple(src_xy), cs.w).astype(np.float64)
            else:
                m = np.eye(3)
            return cls(jnp.asarray(curves, jnp.float32), m.astype(np.float32),
                       float(imaging_ratio))
        r, g, b = data.SENSOR_CURVES[sensor_name]
        curves = np.stack([r, g, b]).astype(np.float64)
        illum = (np.asarray(sensor_illum, np.float64) if sensor_illum is not None
                 else np.asarray(data.ILLUM_D65, np.float64))
        refl = macbeth_reflectances()
        # Sensor-space swatch values under the sensor illuminant.
        rgb_cam = _project_reflectance(refl, illum, curves[0], curves[1], curves[2])
        # XYZ swatch values under the *output space* illuminant.
        out_illum = np.asarray(cs.illuminant, np.float64)
        xyz = _project_reflectance(refl, out_illum,
                                   np.asarray(data.CIE_X, np.float64),
                                   np.asarray(data.CIE_Y, np.float64),
                                   np.asarray(data.CIE_Z, np.float64))
        # Least-squares M: xyz ≈ M @ rgb_cam  (LinearLeastSquares, helpers.h:257)
        m, *_ = np.linalg.lstsq(rgb_cam, xyz, rcond=None)
        return cls(jnp.asarray(curves, jnp.float32),
                   m.T.astype(np.float32), float(imaging_ratio))

    def to_sensor_rgb(self, L, wl):
        """(..., S) radiance + SampledWavelengths → (..., 3) sensor RGB.
        All three response curves are interpolated in one evaluation that
        shares the wavelength indices and weights."""
        w = spec.safe_div(L, wl.pdf)                      # (..., S)
        bars = spec.sample_dense_multi(self.curves.T, wl.lam)  # (..., S, 3)
        rgb = jnp.mean(bars * w[..., None], axis=-2)      # (..., 3)
        return self.imaging_ratio * rgb / spec.CIE_Y_INTEGRAL

    def sensor_rgb_to_xyz(self, rgb):
        m = jnp.asarray(self.xyz_from_sensor_rgb, jnp.float32)
        return jnp.einsum("ij,...j->...i", m, rgb, precision="highest")


def _illum_xyz(illum):
    illum = np.asarray(illum, np.float64)
    return np.array([np.sum(illum * data.CIE_X), np.sum(illum * data.CIE_Y),
                     np.sum(illum * data.CIE_Z)])
