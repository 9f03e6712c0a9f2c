import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips (with its reason) elsewhere")


@pytest.fixture
def harness_threads():
    """The harness's intra-op threads for the test's run, as ``main`` sets
    them: a run on every core beside other test workers crawls."""
    import torch
    from perfbench import harness
    n = torch.get_num_threads()
    torch.set_num_threads(harness.THREADS)
    yield
    torch.set_num_threads(n)
