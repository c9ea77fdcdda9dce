"""Kernel entry points with implementation dispatch.

Counterpart of :mod:`repro.kernels.ops`.  ``impl``:
  * ``"ref"``    — plain PyTorch oracle (:mod:`repro_torch.kernels.ref`)
  * ``"kernel"`` — the Hopper kernels (:mod:`repro_torch.kernels.
    flash_attention`, :mod:`repro_torch.kernels.rglru`,
    :mod:`repro_torch.kernels.wkv6`); on CPU tensors their plain versions
  * ``"chunked"`` — for attention, the FlashAttention-2 schedule in plain
    torch (:mod:`repro_torch.kernels.chunked_attention`) where the call is
    an aligned causal self-attention at S >= ``CHUNKED_ATTENTION_MIN_SEQ``,
    ``ref`` otherwise, on any device; the other entry points take it as
    ``ref``, as the reference's do
  * ``"auto"``   — ``kernel`` for CUDA tensors and for tensors on the meta
    device (a shape-only lowering runs the kernels' shape functions,
    :func:`repro_torch.kernels.build.on_kernel_path`); for CPU tensors
    ``ref``, but for attention as ``chunked``, as the reference routes
    its CPU (``ref``) path

``decode_attention`` and ``decode_attention_partials`` are plain torch
(:mod:`repro_torch.kernels.ref`) on every device and for every ``impl``:
the reference routes both to its ``ref`` on every backend too, since no
Pallas kernel computes them.  This is the reference's routing, not a
fallback.

The reference's TPU gates (``S % 128``, ``hd % 128``, ``W % 128``,
``S % 64``) are not carried over: the kernels mask ragged edges, and on
CUDA a case a kernel does not take raises, it never quietly takes
``ref``.  The reference also sends bidirectional attention (the whisper
encoder) and cross-attention (``Sq != Skv``, the ``C`` blocks) to ``ref``
on every backend; here, on CUDA, the flash kernels compute them, which
take ``Sq != Skv`` with ``causal=False`` and no window and raise on a
causal or windowed one.
"""
from __future__ import annotations

from repro_torch.kernels import chunked_attention as ca
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import rglru as rg
from repro_torch.kernels import wkv6 as wk
from repro_torch.kernels.build import on_kernel_path

IMPLS = ("auto", "ref", "kernel", "chunked")

# Self-attention sequences at or above this length route to the chunked
# (flash-schedule) implementation off the kernel path: the plain path
# materialises (B, H, S, S) scores (reference ``repro.kernels.ops``).
CHUNKED_ATTENTION_MIN_SEQ = 2048


def _resolve(impl: str, t) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    if impl == "auto":
        return "kernel" if on_kernel_path(t) else "ref"
    if impl == "chunked":
        return "ref"
    return impl


def _chunked_block(S: int) -> int:
    """512 where it divides S, else the first of 256, 128, 64 and 1 that
    does (the reference's choice)."""
    return 512 if S % 512 == 0 else next(b for b in (256, 128, 64, 1) if S % b == 0)


def attention(q, k, v, *, q_positions=None, kv_positions=None, causal=True,
              window=None, impl: str = "auto"):
    path = _resolve(impl, q)
    S = q.shape[1]
    aligned_self = (S == k.shape[1] and causal and q_positions is None
                    and kv_positions is None)
    if (impl in ("auto", "chunked") and path == "ref" and aligned_self
            and S >= CHUNKED_ATTENTION_MIN_SEQ):
        block = _chunked_block(S)
        return ca.chunked_attention(q, k, v, causal, window, block, block)
    if path == "ref":
        return ref.attention(q, k, v, q_positions=q_positions,
                             kv_positions=kv_positions, causal=causal,
                             window=window)
    if q_positions is not None or kv_positions is not None:
        raise ValueError("the attention kernels take q at arange(Sq) and kv at "
                         "arange(Skv) only (pass no positions)")
    return fa.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, valid, impl: str = "auto"):
    """(B, 1, H, hd) in q's dtype: one query token against a cache."""
    _resolve(impl, q)
    return ref.decode_attention(q, k, v, valid)


def decode_attention_partials(q, k, v, valid, impl: str = "auto"):
    """Unnormalised partials (o, m, l), f32."""
    _resolve(impl, q)
    return ref.decode_attention_partials(q, k, v, valid)


def rglru(x, r_gate, i_gate, lam, h0=None, impl: str = "auto"):
    """(out (B, S, W) in x's dtype, h_final (B, W) f32)."""
    if _resolve(impl, x) == "ref":
        return ref.rglru(x, r_gate, i_gate, lam, h0=h0)
    return rg.rglru(x, r_gate, i_gate, lam, h0)


def wkv6(r, k, v, w, u, state=None, impl: str = "auto"):
    """(out (B, S, H, hd) in r's dtype, final state (B, H, hd, hd) f32)."""
    if _resolve(impl, r) == "ref":
        return ref.wkv6(r, k, v, w, u, state=state)
    return wk.wkv6(r, k, v, w, u, state)
