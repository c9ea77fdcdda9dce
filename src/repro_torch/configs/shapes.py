"""The four assigned input shapes: a copy of :mod:`repro.configs.shapes`."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
