import os
import sys

import numpy as np
import pytest

# src-layout shim: make `python -m pytest` work without PYTHONPATH=src.
# The repo root is needed too (benchmarks/ imports in several tests).
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_ROOT, os.path.join(_ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def sparse_matrix(rng, m, n, density=0.1):
    return rng.random((m, n)) * (rng.random((m, n)) < density)


@pytest.fixture
def spmat():
    return sparse_matrix


def pytest_sessionfinish(session, exitstatus):
    """Chaos-run gate: when a suite runs under ``$REPRO_FAULTS``, every
    seam fault the injector fired must be covered by a recorded
    DowngradeEvent.  A shortfall is a *silent* downgrade and fails the
    session even if every individual test passed."""
    if not os.environ.get("REPRO_FAULTS"):
        return
    from repro.testing.faults import verify_no_silent_downgrades
    verify_no_silent_downgrades()
