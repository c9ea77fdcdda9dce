"""Test-suite bootstrap.

The property tests use `hypothesis`, which is not part of the pinned
build image.  When the real package is importable we use it; otherwise
we install the deterministic mini-shim from ``_mini_hypothesis.py``
under the ``hypothesis`` module name *before* collection, so the test
modules' ``from hypothesis import given, settings, strategies as st``
keeps working unmodified.
"""
from __future__ import annotations

import importlib.util
import pathlib
import sys
import types


def _install_hypothesis_fallback() -> None:
    try:
        import hypothesis  # noqa: F401  (real library wins when present)
        return
    except ModuleNotFoundError:
        pass
    path = pathlib.Path(__file__).with_name("_mini_hypothesis.py")
    spec = importlib.util.spec_from_file_location("_mini_hypothesis", path)
    assert spec is not None and spec.loader is not None
    mini = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mini)

    hyp = types.ModuleType("hypothesis")
    hyp.given = mini.given
    hyp.settings = mini.settings
    hyp.strategies = mini
    hyp.__mini_shim__ = True
    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = mini


_install_hypothesis_fallback()


def pytest_configure(config) -> None:
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips with a reason elsewhere")
