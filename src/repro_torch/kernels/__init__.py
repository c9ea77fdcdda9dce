"""Counterpart of :mod:`repro.kernels`, and the registry of the port's
kernel modules: each keeps its own launch counter (``LAUNCHES``) and its own
library; these functions read, reset and build them all."""
from __future__ import annotations


def kernel_modules() -> tuple:
    """The modules that hold CUDA kernels, in a fixed order."""
    from repro_torch.kernels import flash_attention, rglru, wkv6

    return (flash_attention, rglru, wkv6)


def all_launches() -> dict[str, int]:
    """Launches per kernel name over every kernel module."""
    return {name: n for mod in kernel_modules() for name, n in mod.LAUNCHES.items()}


def reset_launches() -> None:
    for mod in kernel_modules():
        mod.reset_launches()


def load_libraries() -> None:
    """Build every kernel library (one ``nvcc`` per source, all at once)
    and load each."""
    from repro_torch.kernels.build import build

    mods = kernel_modules()
    build(*(mod.SOURCE for mod in mods))
    for mod in mods:
        mod.load_library()
