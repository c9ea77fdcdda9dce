"""Architecture config registry (``--arch <id>``).

Counterpart of :mod:`repro.configs`: the same ten archs.  The reference's
input shapes (``repro.configs.shapes``) wait for the shape-only lowering
(``ROADMAP.md`` queue 1, item 9).
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

_MODULES = {
    "qwen1.5-4b": "repro_torch.configs.qwen15_4b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_16b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "qwen1.5-32b": "repro_torch.configs.qwen15_32b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a27b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "llama-3.2-vision-90b": "repro_torch.configs.llama32_vision_90b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; one of {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG
