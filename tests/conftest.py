"""Test env: force the CPU backend with 8 virtual devices.

Per SURVEY.md §4: kernel-level unit tests run against numpy oracles and
multi-device tests run on a virtual CPU mesh
(``--xla_force_host_platform_device_count``), no accelerator required.
Set FENIX_TESTS_GPU=1 to keep JAX's default backend instead, so that the
``gpu``-marked tests (``pytest -m gpu``) run on the card.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

if os.environ.get("FENIX_TESTS_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng() -> np.random.Generator:
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is an NVIDIA GPU. Decided here,
    at run time, so that every xdist worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with FENIX_TESTS_GPU=1 -m gpu)")
    return jax.devices()[0]
