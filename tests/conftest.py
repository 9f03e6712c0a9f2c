import numpy as np
import pytest

# NOTE: do NOT set xla_force_host_platform_device_count here — smoke tests
# and benches must see 1 device (the 512-device mesh is dry-run-only).

# analysis_fixtures/ holds miniature repo trees the reprolint tests lint;
# their test_*.py files are lint INPUT, not runnable tests.
collect_ignore_glob = ["analysis_fixtures/*"]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips (with its reason) elsewhere")
