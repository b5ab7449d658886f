"""The benchmark's own tests (run from the checkout's root:
``python -m pytest slambench/tests``).  Tests that need an NVIDIA card carry
``requires_cuda`` and decide inside the test whether one is there."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: needs an NVIDIA GPU and nvcc (run on the card)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
