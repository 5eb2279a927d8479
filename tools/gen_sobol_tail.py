"""Generate the committed Sobol tail table (dims 38..72) via deterministic
CBC search minimizing 2D-projection t-values against all earlier dims
(ops/sobol_quality.py; the Joe-Kuo D(6)-style criterion).

Run:  JAX_PLATFORMS=cpu python tools/gen_sobol_tail.py

Writes computational_ray_tracer_tpu/ops/data/sobol_tail.npz and prints a
per-dim quality report. Deterministic (fixed PCG64 seed): re-running
reproduces the committed table bit-for-bit.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from computational_ray_tracer_tpu.ops import sobol_quality as sq
from computational_ray_tracer_tpu.ops.rng import (_JOE_KUO,
                                                  _primitive_polys_gf2)

N_DIMS = 72          # covers depth-8 paths (dims to 69) with slack
MB = 12              # t-value analysis precision (bits)
N_CAND = 96          # candidates per dim
SEED = 20260821


def main():
    first_tail_dim = len(_JOE_KUO) + 2          # dims 2..37 published
    n_tail = N_DIMS - (len(_JOE_KUO) + 1)

    # The polynomial sequence continues the same enumeration the published
    # table uses (all primitive polys, by degree then 'a' ascending); check
    # the published rows against the enumerator as a consistency gate.
    polys = _primitive_polys_gf2(len(_JOE_KUO) + n_tail)
    for (s, a, _m), (s2, a2) in zip(_JOE_KUO, polys):
        assert (s, a) == (s2, a2), \
            f"published row ({s},{a}) disagrees with enumeration ({s2},{a2})"
    tail_polys = polys[len(_JOE_KUO):]

    # Row masks of every published dim (the fixed prefix the tail is
    # scored against).
    prev_rows = [sq.row_masks(sq.vdc_direction_numbers(), MB)]
    for (s, a, m_init) in _JOE_KUO:
        v = sq.expand_direction_numbers(s, a, m_init)
        prev_rows.append(sq.row_masks(v, MB))

    rng = np.random.Generator(np.random.PCG64(SEED))
    s_out, a_out, m_out, report = [], [], [], []
    for i, (s, a) in enumerate(tail_polys):
        m_init, max_t, total, max_diag = sq.cbc_search_dim(
            prev_rows, s, a, mb=MB, n_candidates=N_CAND, rng=rng)
        v = sq.expand_direction_numbers(s, a, m_init)
        prev_rows.append(sq.row_masks(v, MB))
        d = first_tail_dim + i
        s_out.append(s)
        a_out.append(a)
        m_out.append(m_init + [0] * (16 - len(m_init)))
        report.append((d, s, a, m_init, max_t, max_diag))
        print(f"dim {d:3d}  s={s} a={a:3d}  m={m_init}  "
              f"max_t={max_t}  max_diag={max_diag}")

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "computational_ray_tracer_tpu", "ops", "data",
                       "sobol_tail.npz")
    np.savez(out,
             first_dim=np.int32(first_tail_dim),
             s=np.asarray(s_out, np.int32),
             a=np.asarray(a_out, np.int32),
             m=np.asarray(m_out, np.int32),
             mb=np.int32(MB), seed=np.int64(SEED),
             n_candidates=np.int32(N_CAND))
    print(f"wrote {os.path.normpath(out)}  "
          f"({len(s_out)} dims, worst max_t = "
          f"{max(r[4] for r in report)})")


if __name__ == "__main__":
    main()
