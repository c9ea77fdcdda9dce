"""Architecture config registry (``--arch <id>``).

Counterpart of :mod:`repro.configs`: the same ten archs, the four input
shapes (:mod:`repro_torch.configs.shapes`) and the dry-run matrix over them
(:func:`dryrun_matrix`, which :mod:`repro_torch.launch.dryrun` lowers).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.shapes import SHAPES, InputShape  # noqa: F401
from repro_torch.models.common import ModelConfig

_MODULES = {   # the reference's order
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a27b",
    "qwen1.5-4b": "repro_torch.configs.qwen15_4b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_16b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "llama-3.2-vision-90b": "repro_torch.configs.llama32_vision_90b",
    "qwen1.5-32b": "repro_torch.configs.qwen15_32b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; one of {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


# Archs that legitimately run the 524k-decode shape (sub-quadratic or
# windowed); everything else skips long_500k.
LONG_CONTEXT_ARCHS = ("gemma3-1b", "rwkv6-1.6b", "recurrentgemma-2b")


def shape_applies(arch: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


def dryrun_matrix() -> list[tuple[str, str]]:
    """All (arch, shape) pairs the dry run lowers."""
    return [(a, s) for a in ARCH_IDS for s in SHAPES if shape_applies(a, s)]
