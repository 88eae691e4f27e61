"""Test harness config: CPU jax with 8 virtual devices, unless asked for the GPU.

Property tests on real image fixtures + kernel-vs-reference equivalence,
plus multi-device sharding tests on a virtual CPU mesh.  Tests marked
`gpu` need a card and skip on a CPU; on the card run them with

    RSO_TEST_DEVICE=gpu python -m pytest -m gpu tests/

(chip_smoke.py runs the same selection in its own process).
"""
import os

# Must be set before jax is imported anywhere; force-override any ambient
# platform choice so the suite never lands on an accelerator by accident.
if os.environ.get("RSO_TEST_DEVICE") != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if os.environ.get("RSO_TEST_DEVICE") != "gpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The GPU devices; skips the test where JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run on the card with "
                    "RSO_TEST_DEVICE=gpu python -m pytest -m gpu tests/")
    return jax.devices()
