"""Golden-image regression tests (BASELINE.md row 3): small CPU renders of
the four render configs, asserted allclose against checked-in goldens.

Regenerate after an intentional change with:
    GOLDEN_UPDATE=1 JAX_PLATFORMS=cpu pytest tests/test_golden.py
"""

import os

import numpy as np
import jax
import pytest

from golden_scenes import GOLDEN_DIR, GOLDENS, _render


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden(name):
    if jax.default_backend() != "cpu":
        pytest.skip("goldens are CPU renders")
    img = _render(GOLDENS[name])
    assert np.isfinite(img).all()
    path = os.path.join(GOLDEN_DIR, name + ".npy")
    if os.environ.get("GOLDEN_UPDATE") == "1" or not os.path.exists(path):
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        np.save(path, img.astype(np.float32))
        if os.environ.get("GOLDEN_UPDATE") != "1":
            pytest.fail(f"golden {name} was missing; regenerated — "
                        "commit it and re-run")
        return
    golden = np.load(path)
    # identical sampling decisions (counter RNG); tolerance covers XLA
    # fusion/fastmath drift across compiler versions
    atol = 2e-3 * max(float(golden.max()), 1e-3)
    np.testing.assert_allclose(img, golden, atol=atol,
                               err_msg=f"golden mismatch: {name}")
