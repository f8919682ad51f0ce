"""Shared fixtures.  NOTE: no XLA_FLAGS here on purpose — smoke tests and
benches must see exactly 1 CPU device; multi-device sharding tests run in
subprocesses (tests/test_sharding.py)."""
import jax
import pytest


@pytest.fixture(scope="session")
def key():
    return jax.random.key(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason without one")
