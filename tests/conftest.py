"""Shared pytest fixtures. NOTE: XLA_FLAGS / device-count overrides are
deliberately NOT set here — smoke tests and benches must see 1 device;
only launch/dryrun.py (and subprocess-based distributed tests) force
fake device counts."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import pytest

# Modules dominated by subprocess / multi-device / end-to-end runs; the
# CI split (scripts/ci.sh) runs them after the fast numerics tier.
SLOW_MODULES = {"test_distributed", "test_system", "test_fault_tolerance"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: subprocess / end-to-end tests (scripts/ci.sh "
        "runs them in a second pass after the fast tier)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips inside the test body "
        "when torch.cuda.is_available() is false")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__ in SLOW_MODULES:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)
