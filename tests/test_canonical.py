"""The reference-canonical workload (benchmarks/canonical.py) must keep
producing the committed golden: the one artifact that states 'the
capabilities of the reference' (RayTracerTestApp.h:103-207) is gated in CI
too, not only in the GPU bench and chip_smoke.py."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "benchmarks"))


def test_canonical_matches_committed_golden():
    import canonical

    img, stats = canonical.render(64, 4, cap=40)
    gate = canonical.check_golden(img)
    assert gate["ok"], gate
    # the frame must actually contain the subject (not a black image that
    # trivially matches a black golden)
    assert stats["img_mean"] > 0.01
    assert stats["n_triangles"] == 872320
