"""Counter-based stateless RNG and pixel samplers.

The reference's samplers are *stateful* objects (PCG32 + per-thread instances,
``ThirdParty/pbrv4/{rng.h:24-144, samplers.h:25-327}``) whose key property is
that every draw is a pure function of ``(pixel, sampleIndex, dimension, seed)``
(samplers.h:47-51, 91-99). Here we keep exactly that property but drop the
state: every sample is computed directly from its coordinates with bijective
integer hashing, so any chip/shard computes identical values for identical
coordinates — placement-invariant determinism for free.

Three sampler tiers mirror the reference:
- ``independent_*``  — hash-based uniform (IndependentSampler, samplers.h:38-62)
- ``stratified_*``   — hashed-permutation stratum + jitter
                       (StratifiedSampler, samplers.h:66-136)
- ``sobol_*``        — Owen-scrambled Sobol' points, padded per pixel
                       (SobolSampler capability, samplers.h:144-327; we use the
                       padded-per-pixel formulation which vectorizes cleanly)

All functions are elementwise over arbitrary batch shapes.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# 32-bit mixing primitives (capability of hash.h:18-109 / MixBits)
# ---------------------------------------------------------------------------

def _u32(x):
    return jnp.asarray(x).astype(jnp.uint32)


def mix_bits(x):
    """murmur3 fmix32 finalizer — bijective avalanche mix on uint32."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def hash_u32(*args):
    """Variadic deterministic hash of integer arrays -> uint32 (Hash(...),
    hash.h:96-104). Chained Weyl-sequence absorb + fmix32 finalize."""
    h = jnp.uint32(0x9E3779B9)
    for a in args:
        h = mix_bits(h ^ (_u32(a) * jnp.uint32(0x01000193)))
    return h


def u32_to_float(bits):
    """uint32 -> float32 in [0, 1) using the top 24 bits (exactly
    representable; parity with rng.h:122-124's 0x1p-32 mapping up to f32
    rounding)."""
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


ONE_MINUS_EPSILON = jnp.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))


# ---------------------------------------------------------------------------
# Independent sampler
# ---------------------------------------------------------------------------

def independent_1d(seed, pixel, sample_idx, dim):
    """Uniform [0,1) draw, pure in (seed, pixel, sample, dim)."""
    return u32_to_float(hash_u32(seed, pixel, sample_idx, dim))


def independent_2d(seed, pixel, sample_idx, dim):
    u0 = independent_1d(seed, pixel, sample_idx, dim)
    u1 = independent_1d(seed, pixel, sample_idx, dim + 1)
    return jnp.stack([u0, u1], axis=-1)


# ---------------------------------------------------------------------------
# Kensler cycle-walking permutation (PermutationElement capability,
# Util/HelperFunctions.h:175-206)
# ---------------------------------------------------------------------------

def permutation_element(i, n, p):
    """Random permutation of [0, n) evaluated at i, keyed by p.

    Cycle-walking over the next-power-of-two domain [0, 2^k): the scramble is
    a *provable bijection* mod 2^k (odd-multiply + xorshift + masked xor
    rounds), so the walk starting from i < n always terminates at a value
    < n, and the restriction is a permutation of [0, n). Same decorrelation
    role as the reference's PermutationElement (Util/HelperFunctions.h:175).
    """
    # Static power-of-two fast path: the masked scramble is already a
    # bijection on [0, n), so no cycle walking is needed (skips the
    # while_loop entirely — spp is almost always a power of two).
    n_static = n if isinstance(n, int) else None
    i = _u32(i)
    n = _u32(n)
    p = _u32(p)
    # w = next-pow2-minus-1 mask covering n-1
    w = jnp.maximum(n, jnp.uint32(1)) - jnp.uint32(1)
    w = w | (w >> 1)
    w = w | (w >> 2)
    w = w | (w >> 4)
    w = w | (w >> 8)
    w = w | (w >> 16)

    def scramble(x):
        # Each round is bijective on [0, w+1): odd multiply mod 2^k (masked),
        # xorshift-right (top bits preserved), keyed xor (masked).
        for c_mul, c_xor, s in ((0x9E3779B9 | 1, 0x85EBCA6B, 5),
                                (0xC2B2AE35 | 1, 0x27D4EB2F, 3),
                                (0x165667B1 | 1, 0x9E3779B9, 7)):
            x = (x * jnp.uint32(c_mul)) & w
            x = x ^ (x >> jnp.uint32(s))
            x = x ^ (p & w)
            x = (x * jnp.uint32(c_xor | 1)) & w
            x = x ^ ((p >> jnp.uint32(16)) & w)
            x = x ^ (x >> jnp.uint32(2))
        return x & w

    if n_static is not None and n_static & (n_static - 1) == 0:
        return ((scramble(i) + p) % n).astype(jnp.uint32)

    def cond(x):
        return jnp.any(x >= n)

    def body(x):
        return jnp.where(x >= n, scramble(x), x)

    # Cycle walk: i < n is in its own scramble-cycle, so termination is
    # guaranteed; expected < 2 iterations (domain is < 2n).
    x = jax.lax.while_loop(cond, body, scramble(i))
    return ((x + p) % n).astype(jnp.uint32)


# ---------------------------------------------------------------------------
# Stratified sampler (samplers.h:66-136)
# ---------------------------------------------------------------------------

def stratified_1d(seed, pixel, sample_idx, dim, spp, jitter=True):
    stratum = permutation_element(
        sample_idx, spp, hash_u32(pixel, dim, seed)).astype(jnp.float32)
    delta = jnp.where(jitter, independent_1d(seed, pixel, sample_idx, dim),
                      jnp.float32(0.5))
    return (stratum + delta) / spp


def stratified_2d(seed, pixel, sample_idx, dim, xs, ys, jitter=True):
    """(x-strata, y-strata) grid; spp = xs*ys (samplers.h:107-124)."""
    spp = xs * ys
    stratum = permutation_element(sample_idx, spp, hash_u32(pixel, dim, seed))
    x = (stratum % jnp.uint32(xs)).astype(jnp.float32)
    y = (stratum // jnp.uint32(xs)).astype(jnp.float32)
    dx = jnp.where(jitter, independent_1d(seed, pixel, sample_idx, dim),
                   jnp.float32(0.5))
    dy = jnp.where(jitter, independent_1d(seed, pixel, sample_idx, dim + 1),
                   jnp.float32(0.5))
    return jnp.stack([(x + dx) / xs, (y + dy) / ys], axis=-1)


# ---------------------------------------------------------------------------
# Sobol' low-discrepancy points with Owen scrambling
# ---------------------------------------------------------------------------

def _primitive_polys_gf2(count):
    """Enumerate primitive polynomials over GF(2) in increasing degree
    (encoded as pbrt-style 'a': the inner coefficients, excluding the
    leading and trailing 1). Host-side; replaces a hard-coded Joe-Kuo table
    for the higher dimensions."""
    out = []
    deg = 1
    while len(out) < count:
        order = (1 << deg) - 1
        # candidate poly: x^deg + (bits of a) + 1
        for a in range(1 << (deg - 1)):
            poly = (1 << deg) | (a << 1) | 1
            # primitive iff x has multiplicative order 2^deg - 1 mod poly
            x = 2  # the element 'x'
            ok = True
            # check x^order == 1 and x^(order/p) != 1 for prime factors p
            def polymulmod(u, v):
                r = 0
                while v:
                    if v & 1:
                        r ^= u
                    v >>= 1
                    u <<= 1
                    if u >> deg & 1:
                        u ^= poly
                return r

            def polypow(b, e):
                r = 1
                while e:
                    if e & 1:
                        r = polymulmod(r, b)
                    b = polymulmod(b, b)
                    e >>= 1
                return r

            if polypow(x, order) != 1:
                continue
            # prime factors of order
            n = order
            fac = set()
            p = 2
            while p * p <= n:
                while n % p == 0:
                    fac.add(p)
                    n //= p
                p += 1
            if n > 1:
                fac.add(n)
            for p in fac:
                if polypow(x, order // p) == 1:
                    ok = False
                    break
            if ok:
                out.append((deg, a))
                if len(out) >= count:
                    break
        deg += 1
    return out


# Published Joe-Kuo initial direction numbers (new-joe-kuo-6 tier), dims
# 2..37: (degree s, polynomial a, initial m values). This spans EVERY
# primitive polynomial through degree 7 (1+1+2+2+6+6+18 = 36 dims + van
# der Corput), which covers the headline renderer's consumption (depth-4
# paths use dims up to 37, DIMS_PER_BOUNCE). Dims beyond 37 come from
# ops/data/sobol_tail.npz: a committed, deterministic CBC search that
# minimizes 2D-projection t-values against all earlier dims — the Joe-Kuo
# criterion itself, run here because the reference only *declares* pbrt's
# SobolMatrices32 without shipping the data (Util/HelperFunctions.h:210).
_JOE_KUO = [
    (1, 0, [1]),
    (2, 1, [1, 3]),
    (3, 1, [1, 3, 1]),
    (3, 2, [1, 1, 1]),
    (4, 1, [1, 1, 3, 3]),
    (4, 4, [1, 3, 5, 13]),
    (5, 2, [1, 1, 5, 5, 17]),
    (5, 4, [1, 1, 5, 5, 5]),
    (5, 7, [1, 1, 7, 11, 19]),
    (5, 11, [1, 1, 5, 1, 1]),
    (5, 13, [1, 1, 1, 3, 11]),
    (5, 14, [1, 3, 5, 5, 31]),
    (6, 1, [1, 3, 3, 9, 7, 49]),
    (6, 13, [1, 1, 1, 15, 21, 21]),
    (6, 16, [1, 3, 1, 13, 27, 49]),
    (6, 19, [1, 1, 1, 15, 7, 5]),
    (6, 22, [1, 3, 1, 15, 13, 25]),
    (6, 25, [1, 1, 5, 5, 19, 61]),
    (7, 1, [1, 3, 7, 11, 23, 15, 103]),
    (7, 4, [1, 3, 7, 13, 13, 15, 69]),
    (7, 7, [1, 1, 3, 13, 7, 35, 63]),
    (7, 8, [1, 3, 5, 9, 1, 25, 53]),
    (7, 14, [1, 3, 1, 13, 9, 35, 107]),
    (7, 19, [1, 3, 1, 5, 27, 61, 31]),
    (7, 21, [1, 1, 5, 11, 19, 41, 61]),
    (7, 28, [1, 3, 5, 3, 3, 13, 69]),
    (7, 31, [1, 1, 7, 13, 1, 19, 1]),
    (7, 32, [1, 3, 7, 5, 13, 19, 59]),
    (7, 37, [1, 1, 3, 9, 25, 29, 41]),
    (7, 41, [1, 3, 5, 13, 23, 1, 55]),
    (7, 42, [1, 3, 7, 3, 13, 59, 17]),
    (7, 50, [1, 3, 1, 3, 5, 53, 69]),
    (7, 55, [1, 1, 5, 5, 23, 33, 13]),
    (7, 56, [1, 1, 7, 7, 1, 61, 123]),
    (7, 59, [1, 1, 7, 9, 13, 61, 49]),
    (7, 62, [1, 3, 3, 5, 3, 55, 33]),
]


def _load_tail_initials(first_dim, n_needed):
    """Committed CBC-searched initials for dims >= first_dim (see
    tools/gen_sobol_tail.py). Returns UP TO n_needed (s, a, m_init) rows —
    a request beyond the committed table returns what the table holds so
    callers synthesize only the excess (an all-or-nothing load would
    silently discard the whole validated tail the moment n_dims grows
    past the table), or None if the table is absent/mismatched."""
    import os as _os
    path = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                         "data", "sobol_tail.npz")
    if not _os.path.exists(path):
        return None
    z = np.load(path)
    if int(z["first_dim"]) != first_dim:
        return None
    out = []
    for i in range(min(n_needed, int(z["s"].shape[0]))):
        s = int(z["s"][i])
        out.append((s, int(z["a"][i]), [int(v) for v in z["m"][i, :s]]))
    return out


def _sobol_matrices(n_dims=72, n_bits=32):
    """Generate Sobol' direction-number matrices: van der Corput + the
    published Joe-Kuo initials (dims 2..37) + the committed CBC-validated
    tail (dims 38+; fallback to hashed odd initials only if the committed
    table is absent). Host-side, once."""
    jk = list(_JOE_KUO)
    if n_dims - 1 > len(jk):
        n_extra = (n_dims - 1) - len(jk)
        tail = _load_tail_initials(len(jk) + 2, n_extra)
        if tail:
            jk.extend(tail)
        if n_dims - 1 > len(jk):
            # emergency fallback for dims past the committed table only:
            # valid (odd, in-range) but unscored hashed initials
            n_extra = (n_dims - 1) - len(jk)
            extra = _primitive_polys_gf2(len(jk) + n_extra)[len(jk):]
            rng_h = np.uint64(0x9E3779B97F4A7C15)
            state = np.uint64(12345)
            for (s, a) in extra:
                m_init = []
                for i in range(1, s + 1):
                    with np.errstate(over="ignore"):
                        state = state * rng_h + np.uint64(1)
                    m_init.append(int(state >> np.uint64(40)) % (1 << i) | 1)
                jk.append((s, a, m_init))
    V = np.zeros((n_dims, n_bits), dtype=np.uint32)
    # dim 0: identity (van der Corput)
    for k in range(n_bits):
        V[0, k] = np.uint32(1) << (31 - k)
    for d in range(1, n_dims):
        s, a, m_init = jk[d - 1]
        m = list(m_init)
        for k in range(s, n_bits):
            mk = m[k - s] ^ (m[k - s] << s)
            for t in range(1, s):
                if (a >> (s - 1 - t)) & 1:
                    mk ^= m[k - t] << t
            m.append(mk)
        for k in range(n_bits):
            V[d, k] = np.uint32(m[k] << (31 - k))
    return V


SOBOL_MATRICES = _sobol_matrices()
_SOBOL_J = jnp.asarray(SOBOL_MATRICES)  # (D, 32) uint32
N_SOBOL_DIMS = SOBOL_MATRICES.shape[0]


def sobol_sample_u32(index, dim):
    """Raw 32-bit Sobol' value of point `index` in dimension `dim`
    (elementwise over batches).

    Vectorized over the 32 index bits (mask-select + XOR tree reduction)
    instead of a 32-step sequential fori_loop, which would serialize every
    Sobol draw into 32 dependent steps."""
    index = _u32(index)
    dim = _u32(dim)
    cols = _SOBOL_J[dim]                      # (..., 32) after gather
    ks = jnp.arange(32, dtype=jnp.uint32)
    bits = (index[..., None] >> ks) & jnp.uint32(1)   # (..., 32)
    terms = cols * bits
    # XOR tree reduction over the bit axis: 5 vectorized steps.
    v = terms
    for half in (16, 8, 4, 2, 1):
        v = v[..., :half] ^ v[..., half:2 * half]
    return v[..., 0]


def _reverse_bits32(x):
    x = _u32(x)
    x = ((x >> 1) & jnp.uint32(0x55555555)) | ((x & jnp.uint32(0x55555555)) << 1)
    x = ((x >> 2) & jnp.uint32(0x33333333)) | ((x & jnp.uint32(0x33333333)) << 2)
    x = ((x >> 4) & jnp.uint32(0x0F0F0F0F)) | ((x & jnp.uint32(0x0F0F0F0F)) << 4)
    x = ((x >> 8) & jnp.uint32(0x00FF00FF)) | ((x & jnp.uint32(0x00FF00FF)) << 8)
    return (x >> 16) | (x << 16)


def fast_owen_scramble(v, scramble_seed):
    """Hash-based Owen scrambling (FastOwenScrambler capability,
    samplers.h:186-201): Burley's nested uniform scramble — bit-reverse,
    seeded rounds of ``x ^= x * c`` (each bijective and strictly
    bit-upward-propagating, which is exactly the Owen tree structure), then
    bit-reverse back."""
    v = _reverse_bits32(v)
    v = v + _u32(scramble_seed)
    v = v ^ (v * jnp.uint32(0x6C50B47C))
    v = v ^ (v * jnp.uint32(0xB82F1E52))
    v = v ^ (v * jnp.uint32(0xC7AFE638))
    v = v ^ (v * jnp.uint32(0x8D22F6E6))
    return _reverse_bits32(v)


def binary_permute_scramble(v, scramble_seed):
    """XOR scrambling (BinaryPermuteScrambler, samplers.h:178-184)."""
    return _u32(scramble_seed) ^ _u32(v)


def sobol_owen_1d(seed, pixel, sample_idx, dim, spp=None):
    """Owen-scrambled Sobol' draw, padded per pixel: each (pixel, dim) gets
    its own randomized sequence indexed by sample_idx.

    When ``spp`` is given, the sample index is additionally run through a
    per-(pixel, dim) random permutation of [0, spp) — pointwise decorrelation
    across pixels while keeping the first-spp point *set* (and hence its
    stratification) intact."""
    idx = _u32(sample_idx)
    if spp is not None:
        idx = permutation_element(idx, spp,
                                  hash_u32(seed, pixel, dim, 0x55555555))
    d = _u32(dim) % jnp.uint32(N_SOBOL_DIMS)
    v = sobol_sample_u32(idx, d)
    v = fast_owen_scramble(v, hash_u32(seed, pixel, dim))
    return u32_to_float(v)


def sobol_owen_2d(seed, pixel, sample_idx, dim, spp=None):
    """A 2D Sobol' point: BOTH dims share one shuffled index so the pair
    keeps the (0,2)-sequence property."""
    idx = _u32(sample_idx)
    if spp is not None:
        idx = permutation_element(idx, spp,
                                  hash_u32(seed, pixel, dim, 0x55555555))
    d0 = _u32(dim) % jnp.uint32(N_SOBOL_DIMS)
    d1 = _u32(dim + 1) % jnp.uint32(N_SOBOL_DIMS)
    v0 = fast_owen_scramble(sobol_sample_u32(idx, d0),
                            hash_u32(seed, pixel, dim))
    v1 = fast_owen_scramble(sobol_sample_u32(idx, d1),
                            hash_u32(seed, pixel, dim + 1))
    return jnp.stack([u32_to_float(v0), u32_to_float(v1)], axis=-1)


# ---------------------------------------------------------------------------
# Global Sobol' sampler: one sequence over the whole image
# (SobolSampler + SobolIntervalToIndex capability, samplers.h:144-327)
# ---------------------------------------------------------------------------
#
# The reference maps (pixel, sampleIndex) to the index of the global Sobol'
# point whose first two dimensions land in that pixel (SobolIntervalToIndex
# with precomputed uint64 VdC matrices). Here the same mapping is derived
# from first principles in 32 bits (no uint64 on device): with the image
# scaled to 2^m, the point index i = frame·4^m + j, and the low 2m bits j
# solve a GF(2) linear system "top m bits of dims 0/1 == pixel coords".
# The system's inverse is precomputed host-side per static m; on device the
# solve is a 2m-term mask-XOR reduction — pure elementwise bit ops.

import functools as _functools


def _sobol_u32_host(index, dim):
    v = np.uint32(0)
    index = int(index)
    k = 0
    while index:
        if index & 1:
            v ^= SOBOL_MATRICES[dim, k]
        index >>= 1
        k += 1
    return int(v)


def _gf2_inv(M):
    """Invert a square GF(2) matrix (uint8 0/1 entries) by Gauss-Jordan."""
    n = M.shape[0]
    A = np.concatenate([M.copy() % 2, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = None
        for r in range(col, n):
            if A[r, col]:
                piv = r
                break
        if piv is None:
            raise ValueError("singular GF(2) matrix")
        if piv != col:
            A[[col, piv]] = A[[piv, col]]
        for r in range(n):
            if r != col and A[r, col]:
                A[r] ^= A[col]
    return A[:, n:]


@_functools.lru_cache(maxsize=None)
def _global_sobol_cols(m):
    """For image scale 2^m: uint32 masks C[r] such that the low-2m index
    bits are j = XOR_r bit_r(target ^ u_frame) * C[r], where the 2m-bit
    target packs (px << m) | py MSB-first."""
    nbits = 2 * m
    M = np.zeros((nbits, nbits), np.uint8)
    for k in range(nbits):            # index bit k -> output bits
        x0 = _sobol_u32_host(1 << k, 0)
        x1 = _sobol_u32_host(1 << k, 1)
        vec = ((x0 >> (32 - m)) << m) | (x1 >> (32 - m))
        for r in range(nbits):
            M[r, k] = (vec >> (nbits - 1 - r)) & 1
    Minv = _gf2_inv(M)
    cols = np.zeros(nbits, np.uint32)
    for r in range(nbits):
        mask = 0
        for k in range(nbits):
            if Minv[k, r]:
                mask |= 1 << k
        cols[r] = mask
    # NOTE: return host NumPy, not jnp — the result is lru_cached, and a
    # jnp.asarray issued inside a jit trace is a tracer that would leak
    # into every later trace with the same m.
    return cols


def sobol_global_index(px, py, frame, m):
    """Index of the ``frame``-th global Sobol' point landing in pixel
    (px, py) of the 2^m x 2^m image (SobolIntervalToIndex capability).
    ``m`` is static. Requires frame < 2^(32-2m)."""
    if m == 0:
        return _u32(frame)
    cols = jnp.asarray(_global_sobol_cols(m))       # (2m,) uint32
    i_hi = _u32(frame) << jnp.uint32(2 * m)
    x0 = sobol_sample_u32(i_hi, jnp.uint32(0))
    x1 = sobol_sample_u32(i_hi, jnp.uint32(1))
    sh = jnp.uint32(32 - m)
    u = ((x0 >> sh) << jnp.uint32(m)) | (x1 >> sh)
    t = ((_u32(px) << jnp.uint32(m)) | _u32(py)) ^ u
    nbits = 2 * m
    ks = jnp.arange(nbits, dtype=jnp.uint32)
    bits = (t[..., None] >> (jnp.uint32(nbits - 1) - ks)) & jnp.uint32(1)
    terms = cols * bits
    j = terms[..., 0]
    for k in range(1, nbits):
        j = j ^ terms[..., k]
    return i_hi | j


def sobol_global_pixel2d(seed, px, py, frame, m):
    """The in-pixel fractional position of the global point (GetPixel2D):
    dims 0/1 shifted left by m — the low bits below the pixel grid."""
    idx = sobol_global_index(px, py, frame, m)
    x0 = sobol_sample_u32(idx, jnp.uint32(0)) << jnp.uint32(m)
    x1 = sobol_sample_u32(idx, jnp.uint32(1)) << jnp.uint32(m)
    return jnp.stack([u32_to_float(x0), u32_to_float(x1)], axis=-1)


def _sobol_global_dim_u32(seed, idx, dim):
    """One scrambled global-sequence value. The FastOwen scramble is seeded
    per DIMENSION only (not per pixel): all pixels share one globally
    stratified sequence — that is the whole point of the global mapping.
    Dims beyond the direction-number table wrap, but the scramble stays
    keyed on the UNWRAPPED dim, so reused base dims get independent Owen
    randomizations (deep-bounce dims; dim may be a traced value)."""
    d = _u32(dim) % jnp.uint32(N_SOBOL_DIMS)
    v = sobol_sample_u32(idx, d)
    return fast_owen_scramble(v, hash_u32(seed, dim, 0x6A09E667))


def sobol_global_1d(seed, px, py, frame, dim, m):
    """Global-sequence draw for integrator dimension ``dim`` (int or traced).
    Sequence dims 0/1 are consumed by the pixel mapping, so dim d maps to
    sequence dim d+2."""
    idx = sobol_global_index(px, py, frame, m)
    return u32_to_float(_sobol_global_dim_u32(seed, idx, _u32(dim) + 2))


def sobol_global_2d(seed, px, py, frame, dim, m):
    idx = sobol_global_index(px, py, frame, m)
    d = _u32(dim) + 2
    v0 = _sobol_global_dim_u32(seed, idx, d)
    v1 = _sobol_global_dim_u32(seed, idx, d + 1)
    return jnp.stack([u32_to_float(v0), u32_to_float(v1)], axis=-1)


# ---------------------------------------------------------------------------
# Host-side PCG32 (parity tool for test vectors; rng.h:24-144)
# ---------------------------------------------------------------------------

class PCG32:
    """NumPy implementation of PCG32 with SetSequence/Advance, used host-side
    to cross-check determinism properties in tests (not a device path)."""
    MULT = np.uint64(0x5851F42D4C957F2D)
    DEFAULT_STATE = np.uint64(0x853C49E6748FEA9B)
    DEFAULT_STREAM = np.uint64(0xDA3E39CB94B95BDB)

    def __init__(self, seq_index=None, offset=None):
        self.state = self.DEFAULT_STATE
        self.inc = self.DEFAULT_STREAM
        if seq_index is not None:
            self.set_sequence(np.uint64(seq_index),
                              np.uint64(offset) if offset is not None else None)

    def set_sequence(self, seq_index, offset=None):
        with np.errstate(over="ignore"):
            self.state = np.uint64(0)
            self.inc = (np.uint64(seq_index) << np.uint64(1)) | np.uint64(1)
            self.uniform_u32()
            self.state += (self.DEFAULT_STATE if offset is None
                           else np.uint64(offset))
            self.uniform_u32()

    def uniform_u32(self):
        with np.errstate(over="ignore"):
            old = self.state
            self.state = old * self.MULT + self.inc
            xorshifted = np.uint32(((old >> np.uint64(18)) ^ old) >> np.uint64(27))
            rot = np.uint32(old >> np.uint64(59))
            return np.uint32((xorshifted >> rot) | (xorshifted << ((~rot + np.uint32(1)) & np.uint32(31))))

    def uniform_float(self):
        return min(float(np.float32(self.uniform_u32()) * np.float32(2.0 ** -32)),
                   float(ONE_MINUS_EPSILON))

    def advance(self, delta):
        """O(log n) jump-ahead (rng.h:131-144)."""
        with np.errstate(over="ignore"):
            cur_mult, cur_plus = self.MULT, self.inc
            acc_mult, acc_plus = np.uint64(1), np.uint64(0)
            delta = np.uint64(delta)
            while delta > 0:
                if delta & np.uint64(1):
                    acc_mult *= cur_mult
                    acc_plus = acc_plus * cur_mult + cur_plus
                cur_plus = (cur_mult + np.uint64(1)) * cur_plus
                cur_mult *= cur_mult
                delta >>= np.uint64(1)
            self.state = acc_mult * self.state + acc_plus
