"""Test harness setup.

The suite runs JAX on a virtual 8-device CPU mesh (multi-device sharding
tests per SURVEY.md §4); forcing the platform and the host device count
here, before any jax.devices() call, is sufficient.  Tests that need an
NVIDIA GPU carry the `gpu` marker and skip here; on the card they run
with SEEKSV_TPU_TESTS_ON_DEVICE=1.
"""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

if not os.environ.get("SEEKSV_TPU_TESTS_ON_DEVICE"):
    import jax

    jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

GOLDEN = pathlib.Path(__file__).parent / "golden"
EXAMPLE = pathlib.Path("/root/reference/example")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped on other backends")


@pytest.fixture(scope="session")
def golden_dir():
    return GOLDEN


@pytest.fixture(scope="session")
def example_dir():
    if not EXAMPLE.exists():
        pytest.skip("reference example data not available")
    return EXAMPLE
