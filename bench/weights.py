"""The benchmark's inputs, made from ``--seed``: the parameters, drawn on the
device by the reference family's layout, and the token batches.

All leaves of one dtype are views into one flat buffer filled by one
``torch.randn`` call on a generator of that device, then set to ``mean +
std * z`` leaf by leaf, so the same seed gives the same values to the
program and, drawn again, to the reference."""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

#: each leaf starts on a multiple of this many elements (16-byte aligned)
ALIGN = 64


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for stream ``tags`` of ``seed`` (any non-negative int)."""
    words = np.random.SeedSequence([seed, *tags]).generate_state(2, dtype=np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def draw(rows: list[tuple], seed: int, device) -> dict[tuple, torch.Tensor]:
    """key path -> leaf for each (path, shape, dtype name, mean, std) row."""
    out: dict[tuple, torch.Tensor] = {}
    for tag, dtype_name in enumerate(sorted({r[2] for r in rows})):
        dtype = getattr(torch, dtype_name)
        mine = [r for r in rows if r[2] == dtype_name]
        sizes = [int(np.prod(r[1])) for r in mine]
        offsets = np.cumsum([0] + [-(-n // ALIGN) * ALIGN for n in sizes])
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 0, tag))
        flat = torch.randn(int(offsets[-1]), generator=gen, dtype=dtype, device=device)
        for (path, shape, _, mean, std), off, n in zip(mine, offsets, sizes):
            leaf = flat[int(off):int(off) + n].view(shape)
            if std == 0.0:
                leaf.fill_(mean)
            else:
                leaf.mul_(std).add_(mean)
            out[path] = leaf
    return out


def nest(flat: dict[tuple, torch.Tensor]) -> dict:
    """The nested dict of ``flat``'s key paths."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def batches(seed: int, vocab: int, rows: int, seq: int) -> Iterator[dict[str, np.ndarray]]:
    """Endless batches of ``rows`` sequences: uniform token ids in [0,
    ``vocab``) and their next tokens as labels, int32."""
    rng = np.random.default_rng(sub_seed(seed, 1))
    while True:
        t = rng.integers(0, vocab, (rows, seq + 1), dtype=np.int32)
        yield {"tokens": t[:, :-1], "labels": t[:, 1:]}
