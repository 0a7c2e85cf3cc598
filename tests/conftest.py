"""Suite-wide fixtures."""
import os

import pytest


@pytest.fixture(scope="session", autouse=True)
def _isolated_tune_cache(tmp_path_factory):
    """Point the autotuner's persistent cache at a per-session temp file so
    tests neither read a developer's warm ~/.cache nor leave one behind."""
    path = str(tmp_path_factory.mktemp("tune") / "repro_tune.json")
    prev = os.environ.get("REPRO_TUNE_CACHE")
    os.environ["REPRO_TUNE_CACHE"] = path
    from repro.kernels import tune_cache
    tune_cache.reset()
    yield
    if prev is None:
        os.environ.pop("REPRO_TUNE_CACHE", None)
    else:
        os.environ["REPRO_TUNE_CACHE"] = prev
    tune_cache.reset()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; skips with 'no CUDA' without one")
