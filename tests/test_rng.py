"""RNG / pixel-sampler tests: determinism, decorrelation, stratification,
Sobol' low-discrepancy properties (capability: samplers.h, rng.h, and the
SamplerTestApp point-set checks, SURVEY §3.4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy import stats as sps

from computational_ray_tracer_tpu.ops import rng


def test_determinism_pure_in_coordinates():
    # The reference's key property (samplers.h:47-51): any "thread" computes
    # the same value for the same (pixel, sample, dim, seed).
    a = rng.independent_1d(7, jnp.arange(100), 3, 5)
    b = rng.independent_1d(7, jnp.arange(100), 3, 5)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    c = rng.independent_1d(8, jnp.arange(100), 3, 5)
    assert not np.array_equal(np.asarray(a), np.asarray(c))


def test_independent_uniformity():
    u = rng.independent_1d(0, jnp.arange(100_000), 0, 0)
    u = np.asarray(u)
    assert u.min() >= 0 and u.max() < 1
    stat = sps.kstest(u, "uniform").statistic
    assert stat < 0.01


def test_independent_dims_decorrelated():
    n = 50_000
    pix = jnp.arange(n)
    u0 = np.asarray(rng.independent_1d(0, pix, 0, 0))
    u1 = np.asarray(rng.independent_1d(0, pix, 0, 1))
    assert abs(np.corrcoef(u0, u1)[0, 1]) < 0.02


def test_permutation_element_is_permutation():
    n = 37
    p = rng.permutation_element(jnp.arange(n), n, 12345)
    assert sorted(np.asarray(p).tolist()) == list(range(n))
    p2 = rng.permutation_element(jnp.arange(n), n, 54321)
    assert not np.array_equal(np.asarray(p), np.asarray(p2))


@pytest.mark.parametrize("n", [8, 16, 100, 1000])
def test_permutation_element_sizes(n):
    p = np.asarray(rng.permutation_element(jnp.arange(n), n, 99))
    assert sorted(p.tolist()) == list(range(n))


def test_stratified_1d_covers_strata():
    spp = 16
    u = np.asarray(rng.stratified_1d(0, 42, jnp.arange(spp), 0, spp))
    strata = np.floor(u * spp).astype(int)
    assert sorted(strata.tolist()) == list(range(spp))


def test_stratified_2d_covers_grid():
    xs = ys = 4
    u = np.asarray(rng.stratified_2d(0, 42, jnp.arange(16), 0, xs, ys))
    cells = set()
    for p in u:
        cells.add((int(p[0] * xs), int(p[1] * ys)))
    assert len(cells) == 16  # every stratum hit exactly once


def test_stratified_beats_independent_variance():
    # Integrate f(x)=x over [0,1): stratified error should be much smaller.
    spp = 256
    pixels = jnp.arange(200)[:, None]
    samples = jnp.arange(spp)[None, :]
    us = rng.stratified_1d(0, pixels, samples, 0, spp)
    ui = rng.independent_1d(0, pixels, samples, 0)
    err_s = np.asarray(jnp.abs(jnp.mean(us, axis=1) - 0.5))
    err_i = np.asarray(jnp.abs(jnp.mean(ui, axis=1) - 0.5))
    assert err_s.mean() < err_i.mean() / 4


def test_sobol_first_dim_van_der_corput():
    v = np.asarray(rng.sobol_sample_u32(jnp.arange(8), 0))
    u = v.astype(np.float64) / 2 ** 32
    # van der Corput base 2: 0, 1/2, 1/4, 3/4, 1/8, 5/8, 3/8, 7/8
    np.testing.assert_allclose(u, [0, .5, .25, .75, .125, .625, .375, .875],
                               atol=1e-7)


def test_sobol_2d_stratification():
    # First 2^k 2D Sobol points are stratified: 16 points, one per 4x4 cell.
    idx = jnp.arange(16)
    x = np.asarray(rng.sobol_sample_u32(idx, 0)).astype(np.float64) / 2 ** 32
    y = np.asarray(rng.sobol_sample_u32(idx, 1)).astype(np.float64) / 2 ** 32
    cells = {(int(a * 4), int(b * 4)) for a, b in zip(x, y)}
    assert len(cells) == 16


def test_sobol_owen_scrambled_remains_stratified():
    idx = jnp.arange(64)
    u0 = np.asarray(rng.sobol_owen_1d(0, 5, idx, 0))
    # Owen scrambling preserves (0,2)-sequence stratification in 1D:
    # 64 points -> one per 1/64 interval.
    strata = np.floor(u0 * 64).astype(int)
    assert sorted(strata.tolist()) == list(range(64))


def test_sobol_owen_decorrelated_across_pixels():
    # With per-pixel index shuffling, samples at the same index in different
    # pixels are pointwise decorrelated.
    idx = jnp.arange(1024)
    a = np.asarray(rng.sobol_owen_1d(0, 1, idx, 0, spp=1024))
    b = np.asarray(rng.sobol_owen_1d(0, 2, idx, 0, spp=1024))
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.05
    # ...while the per-pixel point set stays a stratified Sobol' set.
    strata = np.floor(a * 1024).astype(int)
    assert sorted(strata.tolist()) == list(range(1024))


def test_sobol_low_discrepancy_beats_random():
    n = 4096
    idx = jnp.arange(n)
    xs = np.asarray(rng.sobol_owen_1d(0, 0, idx, 0))
    est_sobol = abs(xs.mean() - 0.5)
    xr = np.asarray(rng.independent_1d(0, 0, idx, 0))
    est_rand = abs(xr.mean() - 0.5)
    assert est_sobol < est_rand / 4 or est_sobol < 1e-4


def test_pcg32_reference_vectors():
    # PCG32 with the canonical demo seeding produces a known stream head
    # (O'Neill's pcg32_demo: initstate=42 -> offset, initseq=54 -> sequence;
    # pbrt rng.h SetSequence semantics).
    r = rng.PCG32(54, 42)
    got = [int(r.uniform_u32()) for _ in range(6)]
    assert got == [0xA15C02B7, 0x7B47F409, 0xBA1D3330, 0x83D2F293,
                   0xBFA4784B, 0xCBED606E]


def test_pcg32_advance():
    r1 = rng.PCG32(7, 0)
    seq = [int(r1.uniform_u32()) for _ in range(10)]
    r2 = rng.PCG32(7, 0)
    r2.advance(5)
    assert int(r2.uniform_u32()) == seq[5]


def test_u32_to_float_range():
    u = np.asarray(rng.u32_to_float(jnp.asarray([0, 2**32 - 1], dtype=jnp.uint32)))
    assert u[0] == 0.0
    assert u[1] < 1.0


# ---------------------------------------------------------------------------
# Sobol direction-number table quality
# ---------------------------------------------------------------------------

def test_sobol_published_rows_structural():
    """Dims 2..37: polynomials are exactly the primitive-poly enumeration
    (degree asc, a asc — the published table's order) and every initial
    value is odd and < 2^i."""
    from computational_ray_tracer_tpu.ops.rng import (_JOE_KUO,
                                                      _primitive_polys_gf2)
    polys = _primitive_polys_gf2(len(_JOE_KUO))
    for (s, a, m), (s2, a2) in zip(_JOE_KUO, polys):
        assert (s, a) == (s2, a2)
        assert len(m) == s
        for i, mi in enumerate(m, start=1):
            assert mi % 2 == 1 and 0 < mi < (1 << i)


def test_sobol_tail_loaded_and_valid():
    """The committed CBC tail must actually be what's loaded (not the
    hashed fallback), with odd in-range initials."""
    from computational_ray_tracer_tpu.ops.rng import (_JOE_KUO,
                                                      _load_tail_initials,
                                                      N_SOBOL_DIMS)
    assert N_SOBOL_DIMS >= 72   # depth-8 paths consume dims up to 69
    n_tail = N_SOBOL_DIMS - (len(_JOE_KUO) + 1)
    tail = _load_tail_initials(len(_JOE_KUO) + 2, n_tail)
    assert tail is not None, "ops/data/sobol_tail.npz missing or stale"
    for (s, a, m) in tail:
        assert len(m) == s
        for i, mi in enumerate(m, start=1):
            assert mi % 2 == 1 and 0 < mi < (1 << i)


def test_sobol_2d_projection_t_values_bounded():
    """Every 2D projection in the consumed range keeps a bounded t-value
    at 12-bit precision (the r4 hashed tail reached t=10; the table ships
    max 7, consecutive pairs max 5). Consecutive pairs (the renderer's 2D
    draw pattern) all checked; plus a deterministic sample of arbitrary
    pairs."""
    from computational_ray_tracer_tpu.ops import sobol_quality as sq
    from computational_ray_tracer_tpu.ops.rng import (SOBOL_MATRICES,
                                                      N_SOBOL_DIMS)
    MB = 12
    rows = [sq.row_masks([int(v) for v in SOBOL_MATRICES[d]], MB)
            for d in range(N_SOBOL_DIMS)]
    for r in rows:
        assert sq.dim1_t_value(r, MB) == 0   # every dim a (0,1)-sequence
    for d in range(1, N_SOBOL_DIMS):
        assert sq.pair_t_value(rows[d - 1], rows[d], MB) <= 5
    rs = np.random.RandomState(7)
    for _ in range(200):
        i, j = rs.choice(N_SOBOL_DIMS, size=2, replace=False)
        assert sq.pair_t_value(rows[i], rows[j], MB) <= 7


def test_sobol_deep_dims_chi_square_uniform():
    """Chi-square uniformity of deep-dimension 2D projections (dims 30+):
    4096 raw-net points in
    16x16 bins. The CBC tail (rows 37+) is constrained to zero diagonal
    rank deficiency through j=4, so its consecutive pairs are EXACTLY
    equidistributed here (chi2 = 0; random points give E[chi2] ~ 255).
    One published pair (rows 29/30 — Joe-Kuo dims 31/32) carries an
    inherent (4,4)-split striping; Owen scrambling permutes dyadic boxes
    so per-resolution box counts (and this chi2) are scramble-invariant —
    that is the public data's quality, excluded rather than gated."""
    # the range deliberately starts past the striped published pair
    # (rows 29/30) — see the docstring
    for d0 in list(range(30, 37)) + list(range(37, 71, 4)):
        n = 4096
        idx = jnp.arange(n, dtype=jnp.uint32)
        x = np.asarray(rng.u32_to_float(rng.sobol_sample_u32(idx, d0)))
        y = np.asarray(rng.u32_to_float(rng.sobol_sample_u32(idx, d0 + 1)))
        bins = np.histogram2d(x, y, bins=16, range=[[0, 1], [0, 1]])[0]
        expected = n / 256
        chi2 = float(((bins - expected) ** 2 / expected).sum())
        assert chi2 < 90.0, (d0, chi2)


def test_sobol_tail_partial_load_keeps_committed_rows():
    """Requesting more dims than the committed table holds must return
    the committed rows (callers synthesize only the excess) — an
    all-or-nothing load would silently regress every tail dim to hashed
    initials the moment n_dims grows."""
    from computational_ray_tracer_tpu.ops.rng import (_JOE_KUO,
                                                      _load_tail_initials,
                                                      _sobol_matrices,
                                                      SOBOL_MATRICES)
    first = len(_JOE_KUO) + 2
    committed = _load_tail_initials(first, 10_000)
    assert committed is not None and len(committed) >= 35
    # a widened table keeps the committed prefix bit-identical
    V = _sobol_matrices(n_dims=80)
    np.testing.assert_array_equal(V[:SOBOL_MATRICES.shape[0]],
                                  SOBOL_MATRICES)
