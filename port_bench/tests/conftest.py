import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card with CUDA; skips without one "
        "(run `python -m pytest -m cuda port_bench/tests` on the card)")


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
