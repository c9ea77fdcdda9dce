"""Checkpointing: flat-key npz save/restore for parameter and optimizer
trees, with step metadata.

Counterpart of :mod:`repro.checkpoint.ckpt`, with the same file layout:
``params/<key path>`` and ``opt/<key path>`` arrays joined by ``/``, and a
JSON ``__meta__``.  A bfloat16 leaf is written as its 16-bit patterns in a
two-byte void array, the ``|V2`` descriptor the reference's ``np.savez``
gives an ``ml_dtypes`` bfloat16 array, and a ``|V2`` leaf is read back
through a ``uint16`` view; so files pass between the two packages bit for
bit, and neither side needs ``ml_dtypes``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.models.transformer import leaf_order, map_leaves

SEP = "/"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as ``like``'s dtype on its device; ``arr`` is the fresh array
    ``np.load`` read, so it is wrapped, not copied."""
    if arr.dtype == np.dtype("V2"):
        if like.dtype != torch.bfloat16:
            raise ValueError(f"a bfloat16 leaf cannot restore a {like.dtype} one")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr).to(like.dtype)
    return t.to(like.device)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {SEP.join(map(str, path)): _to_numpy(leaf) for path, leaf in leaf_order(tree)}


def save_checkpoint(path: str | Path, params: Any, opt_state: Any = None,
                    step: int = 0, extra: dict | None = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {f"params{SEP}{k}": v for k, v in _flatten(params).items()}
    if opt_state is not None:
        arrays.update({f"opt{SEP}{k}": v for k, v in _flatten(opt_state).items()})
    np.savez(path, __meta__=json.dumps({"step": step, **(extra or {})}), **arrays)


def restore_checkpoint(path: str | Path, params_like: Any, opt_state_like: Any = None):
    """``(params, opt_state, meta)`` in the structure, dtypes and devices of
    the templates (e.g. freshly initialised parameters); a leaf whose shape
    differs from its template's raises ``ValueError``."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))

        def fill(template: Any, prefix: str) -> Any:
            def leaf(key_path: tuple, like: torch.Tensor) -> torch.Tensor:
                key = SEP.join(map(str, key_path))
                arr = z[f"{prefix}{SEP}{key}"]
                if arr.shape != tuple(like.shape):
                    raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                                     f"{tuple(like.shape)}")
                return _from_numpy(arr, like)

            return map_leaves(leaf, template)

        params = fill(params_like, "params")
        opt_state = fill(opt_state_like, "opt") if opt_state_like is not None else None
    return params, opt_state, meta
