"""Registers the marker of the tests that need an NVIDIA card (they decide
inside the test whether one is present, and skip with a reason if not)."""


def pytest_configure(config) -> None:
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips with a reason elsewhere")
