"""Pytest settings of the suite: the marker of the tests that need a CUDA
card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (the same "
        "check runs on the card in chip_smoke.py)")
