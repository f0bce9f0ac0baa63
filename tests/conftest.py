import numpy as np
import pytest

import jax


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    """Point the autotune disk cache at a per-test path so a developer's
    real ~/.cache/repro/tune.json can't change kernel configs under tests
    (tests that exercise persistence explicitly override this)."""
    monkeypatch.setenv("REPRO_TUNE_CACHE_PATH", str(tmp_path / "tune.json"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (deselect with '-m \"not slow\"')")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
    # keep smoke tests on the single real device; the dry-run sets its own
    # XLA_FLAGS before importing jax (see launch/dryrun.py)
    assert jax.device_count() >= 1
