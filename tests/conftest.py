def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card with CUDA; skips without one "
        "(run `python -m pytest -m cuda tests/test_torch_*.py` on the card)",
    )
