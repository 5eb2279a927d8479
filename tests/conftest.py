"""Test configuration: run tests on 8 virtual CPU devices so the full
multi-device sharding path executes without accelerators (SURVEY §4: the CPU
device mesh is our 'fake backend'). The default device is pinned to the CPU
even where a GPU is present; tests marked ``gpu`` place their work on the
card themselves and skip where there is none (the ``gpu_device`` fixture).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_threefry_partitionable", True)
jax.config.update("jax_default_device", jax.devices("cpu")[0])


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one "
        "(python chip_smoke.py runs them on the card)")


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where there is none."""
    try:
        return jax.devices("cuda")[0]
    except RuntimeError:
        pytest.skip("needs a CUDA device")


def cpu_devices():
    return jax.devices("cpu")
