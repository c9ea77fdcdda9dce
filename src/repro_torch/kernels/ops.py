"""Kernel entry points with implementation dispatch.

Counterpart of :mod:`repro.kernels.ops`.  ``impl``:
  * ``"ref"``    — plain PyTorch oracle (:mod:`repro_torch.kernels.ref`)
  * ``"kernel"`` — the Hopper kernels (:mod:`repro_torch.kernels.
    flash_attention`); on CPU tensors their plain versions
  * ``"auto"``   — ``kernel`` for CUDA tensors, ``ref`` for CPU tensors

The reference's TPU gates (``S % 128``, ``hd % 128``) are not carried
over: on CUDA a case the kernel does not take raises, it never quietly
takes ``ref``.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

IMPLS = ("auto", "ref", "kernel")


def attention(q, k, v, *, q_positions=None, kv_positions=None, causal=True,
              window=None, impl: str = "auto"):
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    if impl == "auto":
        impl = "kernel" if q.is_cuda else "ref"
    if impl == "ref":
        return ref.attention(q, k, v, q_positions=q_positions,
                             kv_positions=kv_positions, causal=causal,
                             window=window)
    if q_positions is not None or kv_positions is not None:
        raise ValueError("the attention kernel takes aligned self-attention "
                         "positions only (pass none)")
    return fa.flash_attention(q, k, v, causal=causal, window=window)
