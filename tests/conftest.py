"""Test configuration: force an 8-device virtual CPU mesh.

Multi-device sharding paths are exercised on virtual CPU devices, per the
project's test strategy (SURVEY.md §4): the reference has no test framework
at all, so unit tests, golden-model parity, and sharded-statistics tests are
all new here.  Backends are initialized lazily, so these config updates win
as long as they run before the first JAX operation.

Tests of code that runs only on an NVIDIA GPU (the CUDA decoder) carry the
``gpu`` marker and take the ``gpu`` fixture, which skips them unless the
default device is a GPU.  ``MYLDPC_TESTS_ON_GPU=1`` leaves the platform to
JAX instead of forcing the CPU; ``python chip_smoke.py`` runs the marked
tests that way on the card.
"""
import os

import jax

if os.environ.get("MYLDPC_TESTS_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    # no persistent compile cache on the CPU (entry points under test set one)
    jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavyweight test (>10 s: n=64800 constructions, full rate "
        'grids) — excluded by -m "not slow" for the inner-loop subset; the '
        "full suite still runs them",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (CUDA kernels); skipped elsewhere, run on "
        "the card by `python chip_smoke.py`",
    )


@pytest.fixture
def gpu():
    """The GPU device; skips the test when the default device is not one."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (default device: {dev.platform})")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
