"""Test config: JAX on an 8-device virtual CPU mesh (SURVEY.md §5.4).

The suite runs on the CPU backend unless JAX_PLATFORMS says otherwise
(it must be set before jax is first imported, hence module level here).
Tests marked `gpu` need the card and skip elsewhere; run them on it with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402,F401


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where JAX finds none")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX finds none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run: JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/)")
    return devs[0]
