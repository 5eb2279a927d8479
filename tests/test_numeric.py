"""Unit tests for the L0 numeric helper surface (helpers.h capability)."""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from computational_ray_tracer_tpu.ops import numeric as num


def test_two_prod_exact():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.normal(size=256).astype(np.float32)) * 1e3
    b = jnp.asarray(rng.normal(size=256).astype(np.float32)) * 1e-3
    prod, err = num.two_prod(a, b)
    exact = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    recon = np.asarray(prod, np.float64) + np.asarray(err, np.float64)
    np.testing.assert_allclose(recon, exact, rtol=1e-12)


def test_two_sum_exact():
    a = jnp.float32(1e8)
    b = jnp.float32(1.5)
    s, err = num.two_sum(a, b)
    assert float(s) + float(err) == 1e8 + 1.5


def test_compensated_sum_beats_naive():
    # 1 + many tiny values that individually vanish in f32 accumulation
    n = 20000
    vals = np.full((n,), np.float32(1e-7))
    vals[0] = np.float32(1.0)
    naive = np.float32(0.0)
    for v in vals:  # sequential f32 naive sum loses the tail
        naive += v
    comp = float(num.compensated_sum(jnp.asarray(vals), axis=0))
    exact = 1.0 + (n - 1) * 1e-7
    assert abs(comp - exact) <= abs(float(naive) - exact)
    np.testing.assert_allclose(comp, exact, rtol=1e-6)


def test_evaluate_polynomial_horner():
    t = jnp.linspace(-2.0, 2.0, 64)
    got = num.evaluate_polynomial(t, 1.0, -3.0, 0.5, 2.0)
    want = 1.0 - 3.0 * t + 0.5 * t ** 2 + 2.0 * t ** 3
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_find_interval_bracket_and_clamp():
    vals = jnp.asarray([0.0, 1.0, 2.0, 5.0, 9.0])
    x = jnp.asarray([-1.0, 0.0, 0.5, 1.0, 4.9, 9.0, 20.0])
    i = np.asarray(num.find_interval(vals, x))
    np.testing.assert_array_equal(i, [0, 0, 0, 1, 2, 3, 3])
    v = np.asarray(vals)
    inner = (np.asarray(x) >= 0) & (np.asarray(x) < 9.0)
    assert np.all(v[i[inner]] <= np.asarray(x)[inner])
    assert np.all(np.asarray(x)[inner] < v[i[inner] + 1])


def test_gaussian_normalization_and_integral():
    x = np.linspace(-8, 8, 20001)
    pdf = np.asarray(num.gaussian(jnp.asarray(x), 0.5, 1.3))
    np.testing.assert_allclose(np.trapezoid(pdf, x), 1.0, atol=1e-4)
    got = float(num.gaussian_integral(jnp.asarray(-1.0), jnp.asarray(2.0),
                                      0.5, 1.3))
    lo = np.searchsorted(x, -1.0)
    hi = np.searchsorted(x, 2.0)
    np.testing.assert_allclose(got, np.trapezoid(pdf[lo:hi], x[lo:hi]),
                               atol=1e-3)


def test_windowed_sinc_support_and_center():
    assert float(num.sinc(jnp.asarray(0.0))) == 1.0
    np.testing.assert_allclose(float(num.sinc(jnp.asarray(1.0))), 0.0,
                               atol=1e-6)
    ws = num.windowed_sinc(jnp.asarray([0.0, 3.5, 5.0]), 4.0, 3.0)
    assert float(ws[0]) == 1.0
    assert float(ws[2]) == 0.0


def test_linear_least_squares_recovers_exact_solution():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(24, 3)).astype(np.float32)
    X_true = rng.normal(size=(3, 3)).astype(np.float32)
    B = A @ X_true
    X = np.asarray(num.linear_least_squares(A, B))
    np.testing.assert_allclose(X, X_true, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("shape", [(5,), (4, 3)])
def test_select_rows_is_clamped_gather(shape):
    rng = np.random.default_rng(1)
    tab = rng.normal(size=shape).astype(np.float32)
    idx = np.array([[0, 3, -2], [7, 1, 2]], np.int32)
    got = np.asarray(num.select_rows(jnp.asarray(tab), jnp.asarray(idx)))
    want = tab[np.clip(idx, 0, shape[0] - 1)]
    np.testing.assert_array_equal(got, want)
