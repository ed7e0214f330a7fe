"""Shared test fixtures.

NOTE: do NOT set XLA_FLAGS / host-device-count here — smoke tests and
benchmarks must see the real single CPU device; only launch/dryrun.py forces
512 placeholder devices (and it does so before importing jax).
"""
import os

# Keep XLA single-threaded-ish and quiet for CI stability.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import numpy as np
import pytest


@pytest.fixture()
def interpret_backend(monkeypatch):
    """Pin dispatch.select_backend() to Pallas interpret mode.

    Off-TPU the production backend is the jnp reference/oracle path
    (interpret emulation is slower than plain jnp on CPU) — test modules
    whose point is exercising the exact BlockSpec tiling through
    dispatch/ICR declare this fixture autouse so they keep running the
    kernels bit-for-bit regardless of the production default.
    """
    monkeypatch.setenv("REPRO_BACKEND", "interpret")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line("markers", "x64: requires float64")
    config.addinivalue_line(
        "markers", "cuda: runs a CUDA kernel; skips without a CUDA card")
