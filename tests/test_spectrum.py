"""Spectral core tests (reference capability: SpectrumColorTestApp.h,
spectrum.h/cpp printed known answers — here as asserted pytest checks)."""

import numpy as np
import jax.numpy as jnp
import pytest

from computational_ray_tracer_tpu.ops import spectra_data as data
from computational_ray_tracer_tpu.ops import spectrum as spec


def test_cie_y_integral_close_to_reference_constant():
    # Reference pins 106.856895 (spectrum.h:21); the measured ybar table must
    # sum to it (same 1nm Riemann sum as InnerProduct, spectrum.h:762-768).
    assert spec.CIE_Y_INTEGRAL == 106.856895
    assert abs(float(np.sum(data.CIE_Y.astype(np.float64))) - 106.856895) < 1e-3


def test_cmf_tables_match_analytic_fits():
    # The measured CIE tables and the Wyman/Sloan/Shirley analytic fits are
    # independent sources; they should agree to a few percent of peak.
    for table, fit in ((data.CIE_X, data.cie_x_fit),
                       (data.CIE_Y, data.cie_y_fit),
                       (data.CIE_Z, data.cie_z_fit)):
        err = np.max(np.abs(table - fit(data.DENSE_LAMBDA))) / np.max(table)
        assert err < 0.05, err


def test_cmf_peaks():
    lam = data.DENSE_LAMBDA
    assert abs(lam[np.argmax(data.CIE_Y)] - 555.0) < 8
    assert abs(lam[np.argmax(data.CIE_Z)] - 445.0) < 10
    # x has its main peak near 600nm
    assert abs(lam[np.argmax(data.CIE_X)] - 599.0) < 8


def test_blackbody_wien_peak():
    # Peak of 5000K blackbody at ~579.6nm (Wien) — matches the reference's
    # BlackbodySpectrum normalization logic (spectrum.h:24-36).
    bb = spec.BlackbodySpectrum(5000.0)
    lam = jnp.linspace(200.0, 2000.0, 3601)
    v = bb(lam)
    peak = float(lam[int(jnp.argmax(v))])
    assert abs(peak - 579.6) < 2.0
    assert float(jnp.max(v)) == pytest.approx(1.0, abs=1e-3)


def test_sample_uniform_wavelengths_stratified_wrap():
    wl = spec.sample_uniform_wavelengths(jnp.float32(0.9))
    assert wl.lam.shape == (8,)
    assert float(jnp.min(wl.lam)) >= spec.LAMBDA_MIN
    assert float(jnp.max(wl.lam)) <= spec.LAMBDA_MAX
    np.testing.assert_allclose(np.asarray(wl.pdf),
                               1.0 / (spec.LAMBDA_MAX - spec.LAMBDA_MIN))
    # all 8 distinct strata
    assert len(np.unique(np.round(np.asarray(wl.lam), 3))) == 8


def test_visible_sampling_inverse_consistency():
    u = jnp.linspace(0.01, 0.99, 64)
    lam = spec.sample_visible_wavelength(u)
    pdf = spec.visible_wavelengths_pdf(lam)
    assert float(jnp.min(lam)) >= spec.LAMBDA_MIN - 1
    assert float(jnp.max(lam)) <= spec.LAMBDA_MAX + 1
    assert np.all(np.asarray(pdf) > 0)
    # pdf integrates to ~1 over the range
    grid = jnp.linspace(spec.LAMBDA_MIN, spec.LAMBDA_MAX, 4001)
    integral = float(jnp.trapezoid(spec.visible_wavelengths_pdf(grid), grid))
    assert integral == pytest.approx(1.0, abs=0.01)


def test_visible_importance_mc_unbiased():
    # E[f(lam)/pdf(lam)] should equal the integral of f for an easy f.
    wl = spec.sample_visible_wavelengths(jnp.linspace(0.001, 0.999, 4096))
    f = jnp.ones_like(wl.lam)
    est = float(jnp.mean(spec.safe_div(f, wl.pdf)))
    assert est == pytest.approx(spec.LAMBDA_MAX - spec.LAMBDA_MIN, rel=0.02)


def test_densely_sampled_interp_and_out_of_range():
    d = spec.DenselySampledSpectrum.from_named("stdillum-D65")
    # Registry illuminants are luminance-normalized (Spectra::Init,
    # spectrum.cpp:158-160): InnerProduct(spd, ybar) == CIE_Y_integral.
    lum = float(np.sum(np.asarray(d.values, np.float64)
                       * data.CIE_Y.astype(np.float64))) / spec.CIE_Y_INTEGRAL
    assert lum == pytest.approx(1.0, abs=1e-4)
    assert float(d(jnp.float32(100.0))) == 0.0
    assert float(d(jnp.float32(900.0))) == 0.0


def test_piecewise_linear_from_interleaved():
    p = spec.PiecewiseLinearSpectrum.from_interleaved(
        [400.0, 1.0, 500.0, 3.0, 600.0, 2.0])
    assert float(p(jnp.float32(450.0))) == pytest.approx(2.0, abs=1e-5)
    assert float(p(jnp.float32(399.0))) == 0.0


def test_constant_spectrum():
    c = spec.ConstantSpectrum(2.5)
    out = c(jnp.zeros((4, 8)))
    assert out.shape == (4, 8)
    np.testing.assert_allclose(np.asarray(out), 2.5)


def test_sampled_to_xyz_matches_dense_quadrature():
    # MC hero-wavelength XYZ of D65 should converge to the dense quadrature.
    d65 = spec.DenselySampledSpectrum.from_named("stdillum-D65")
    exact = np.asarray(spec.spectrum_to_xyz(d65))
    us = jnp.linspace(0.0005, 0.9995, 2000)
    wl = spec.sample_visible_wavelengths(us)
    L = d65(wl.lam)
    est = np.asarray(jnp.mean(spec.sampled_to_xyz(L, wl), axis=0))
    np.testing.assert_allclose(est, exact, rtol=0.02)


def test_terminate_secondary():
    wl = spec.sample_visible_wavelengths(jnp.float32(0.3))
    t = wl.terminate_secondary()
    assert bool(t.secondary_terminated())
    assert not bool(wl.secondary_terminated())
    # terminating twice is idempotent
    t2 = t.terminate_secondary()
    np.testing.assert_allclose(np.asarray(t2.pdf), np.asarray(t.pdf))


def test_named_registry_contents():
    for name in ["stdillum-A", "stdillum-D50", "stdillum-D65", "stdillum-F1",
                 "stdillum-F12", "cie-x", "glass-BK7-eta", "metal-Au-eta",
                 "metal-Au-k"]:
        v = data.get_named_spectrum(name)
        assert v.shape == (471,)


def test_bk7_sellmeier_known_value():
    # n_d of BK7 at 587.6nm is 1.5168 (Schott catalog).
    n = data.sellmeier_ior(np.array([587.6]), data._SELLMEIER["glass-BK7"])[0]
    assert n == pytest.approx(1.5168, abs=2e-4)


def test_illuminant_a_is_2856K_blackbody():
    # The measured CIE A table must match Planck's law at 2856K (its defining
    # model) after matching scale at 560nm — independent-physics oracle.
    a = data.ILLUM_A.astype(np.float64)
    a = a / np.interp(560.0, data.DENSE_LAMBDA, a)
    bb = data.blackbody(data.DENSE_LAMBDA, 2856.0)
    bb = bb / np.interp(560.0, data.DENSE_LAMBDA, bb)
    np.testing.assert_allclose(a, bb, rtol=2e-3)


def _interp_rows_np(table, rows, lam):
    """NumPy reference: per-ray row of a dense 1 nm table, linearly
    interpolated at each wavelength, 0 outside [360, 830]."""
    rows = np.clip(rows, 0, table.shape[0] - 1)
    grid = np.asarray(data.DENSE_LAMBDA, np.float64)
    out = np.zeros(lam.shape)
    for i in np.ndindex(rows.shape):
        out[i] = np.interp(lam[i], grid, table[rows[i]], left=0.0,
                           right=0.0)
    return out


@pytest.mark.parametrize("m", [1, 4])
def test_sample_dense_rows_matches_numpy(m):
    rng = np.random.default_rng(m)
    table = rng.uniform(0.0, 2.0, (m, data.N_DENSE)).astype(np.float32)
    rows = rng.integers(-1, m + 1, (6, 5)).astype(np.int32)
    lam = rng.uniform(340.0, 850.0, (6, 5, 8)).astype(np.float32)
    got = np.asarray(spec.sample_dense_rows(jnp.asarray(table),
                                            jnp.asarray(rows),
                                            jnp.asarray(lam)))
    np.testing.assert_allclose(got, _interp_rows_np(table, rows, lam),
                               rtol=1e-5, atol=1e-6)


def test_sample_dense_rows_multi_matches_numpy():
    rng = np.random.default_rng(9)
    tables = [rng.uniform(0.0, 2.0, (3, data.N_DENSE)).astype(np.float32)
              for _ in range(3)]
    rows = rng.integers(0, 3, (40,)).astype(np.int32)
    lam = rng.uniform(360.0, 830.0, (40, 8)).astype(np.float32)
    got = spec.sample_dense_rows_multi([jnp.asarray(t) for t in tables],
                                       jnp.asarray(rows), jnp.asarray(lam))
    assert len(got) == 3
    for g, t in zip(got, tables):
        np.testing.assert_allclose(np.asarray(g),
                                   _interp_rows_np(t, rows, lam),
                                   rtol=1e-5, atol=1e-6)


def test_sample_dense_multi_matches_numpy():
    rng = np.random.default_rng(4)
    tables = rng.uniform(0.0, 1.0, (data.N_DENSE, 5)).astype(np.float32)
    lam = rng.uniform(350.0, 840.0, (7, 8)).astype(np.float32)
    got = np.asarray(spec.sample_dense_multi(jnp.asarray(tables),
                                             jnp.asarray(lam)))
    for c in range(5):
        want = _interp_rows_np(tables.T[c:c + 1],
                               np.zeros(lam.shape[:-1], np.int32), lam)
        np.testing.assert_allclose(got[..., c], want, rtol=1e-5, atol=1e-6)
