"""NumPy / torch namespace dispatch for the shared cost kernels.

Counterpart of :mod:`repro.core.xputil`.  The dtype-polymorphic numerics —
the collective models in :mod:`repro_torch.core.hardware`, the WFBP
prefix-max residual and the worker reductions in
:mod:`repro_torch.core.analytical` and the bucket-timeline residual in
:mod:`repro_torch.core.bucketsim` — are written once against whichever
array namespace their inputs live in: plain NumPy for the batched engine
(:mod:`repro_torch.core.batched`) and torch for its twin on the card
(:mod:`repro_torch.core.batched_torch`), autograd included.

Where torch is not NumPy-compatible the torch namespace adapts:
``min``/``max`` over an axis are ``amin``/``amax`` (torch's return
``(values, indices)``), a Python-scalar operand of ``minimum``/``maximum``/
``clip`` becomes a tensor on the other operand's device, and the module
functions :func:`astype` (tensors have no ``.astype``) and
:func:`max_or_zero` (``x.max(axis, initial=0.0)``: torch has no
``initial``, and its max over an empty axis raises) serve both.  Tensors
keep their own dtype and device; nothing here sets a default dtype.

torch is resolved lazily through ``sys.modules``, so the NumPy engine
never imports it.
"""
from __future__ import annotations

import sys
from typing import Any

import numpy as np


def is_tensor(x: Any) -> bool:
    """True when ``x`` is a torch tensor — without importing torch if
    nothing has imported it yet (then nothing can be one)."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


class _TorchNamespace:
    """The NumPy functions the shared kernels call, on torch tensors of
    ``device``."""

    def __init__(self, device):
        import torch

        self._torch = torch
        self.device = device
        self.float64 = torch.float64
        self.int64 = torch.int64

    def asarray(self, x, dtype=None):
        if is_tensor(x):
            return x if dtype is None else x.to(dtype)
        return self._torch.as_tensor(x, dtype=dtype, device=self.device)

    def _pair(self, a, b):
        if not is_tensor(a):
            a = self._torch.as_tensor(a, dtype=b.dtype, device=b.device)
        if not is_tensor(b):
            b = self._torch.as_tensor(b, dtype=a.dtype, device=a.device)
        return a, b

    def minimum(self, a, b):
        return self._torch.minimum(*self._pair(a, b))

    def maximum(self, a, b):
        return self._torch.maximum(*self._pair(a, b))

    def clip(self, x, lo, hi):
        lo, x = self._pair(lo, x)
        hi, x = self._pair(hi, x)
        return self._torch.clamp(x, lo, hi)

    def where(self, cond, a, b):
        return self._torch.where(cond, a, b)

    def frexp(self, x):
        return self._torch.frexp(x)

    def min(self, x, axis):
        return self._torch.amin(x, dim=axis)

    def max(self, x, axis):
        return self._torch.amax(x, dim=axis)

    def cumsum(self, x, axis):
        return self._torch.cumsum(x, dim=axis)

    def flip(self, x, axis):
        return self._torch.flip(x, dims=(axis,))

    def sort(self, x, axis):
        return self._torch.sort(x, dim=axis).values

    def broadcast_to(self, x, shape):
        return self._torch.broadcast_to(x, tuple(shape))

    def take_along_axis(self, x, idx, axis):
        return self._torch.take_along_dim(x, idx, dim=axis)


def array_namespace(*args: Any):
    """A torch namespace on the device of the first tensor argument if any
    argument is a tensor, else :mod:`numpy` — the single dispatch point of
    the polymorphic kernels."""
    for a in args:
        if is_tensor(a):
            return _TorchNamespace(a.device)
    return np


def astype(x, dtype):
    """``x.astype(dtype)`` for an array, ``x.to(dtype)`` for a tensor."""
    return x.to(dtype) if is_tensor(x) else x.astype(dtype)


def max_or_zero(x, axis: int):
    """``x.max(axis=axis, initial=0.0)``: the max over ``axis`` and 0, and
    exactly 0 where the axis is empty."""
    if not is_tensor(x):
        return x.max(axis=axis, initial=0.0)
    if x.shape[axis] == 0:
        return x.sum(dim=axis)             # 0 over an empty axis
    return x.amax(dim=axis).clamp_min(0.0)
