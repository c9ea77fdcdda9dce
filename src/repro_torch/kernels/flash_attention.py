"""Flash attention for Hopper: forward and backward CUDA kernels.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::
_flash_kernel`` (Pallas, forward only).  The kernels live in
``repro_torch/csrc/flash_attention.cu``: built at first use with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` and launched on PyTorch's current stream
(:mod:`repro_torch.kernels.build`).  The source's header
says what bounds them on the card and what the design does about it.

Four wrappers, one per kernel, each with a launch counter in
:data:`LAUNCHES` and a plain PyTorch version beside it:

==================  ======================  ============================
wrapper             kernel                  plain version
==================  ======================  ============================
:func:`fwd`         ``flash_fwd``           :func:`plain_fwd`
:func:`bwd_delta`   ``flash_bwd_delta``     :func:`plain_bwd_delta`
:func:`bwd_dq`      ``flash_bwd_dq``        :func:`plain_bwd` (dq)
:func:`bwd_dkdv`    ``flash_bwd_dkdv``      :func:`plain_bwd` (dk, dv)
==================  ======================  ============================

For bfloat16 the forward, dq and dk/dv kernels run on the tensor cores
(``mma.sync``) and take P (and dS) as a hi + lo pair of bfloat16 values:
rounded once, they would put the outputs over the bfloat16 check's limit
(:func:`round_operand` emulates the choice for the CPU tests, in
:func:`plain_fwd` and :func:`plain_bwd`).  Their bound at the main
paths' shapes is the tensor cores' rate (the forward's, at qwen1.5-4b's
shape, its bytes, just under the ridge); they run 8-12x above it
(``PERF.md``), which ``wgmma`` fed by TMA would narrow.
``flash_bwd_delta`` only moves bytes: it reads 16 bytes a lane.  With more than one query head per kv head,
``flash_bwd_dkdv`` writes float32 partials per query head and
:func:`bwd_dkdv` sums them over the group (:func:`sum_groups`).  float32
keeps the FMA kernels: TF32 would not meet its 2e-4 check.

A wrapper given CPU tensors computes its plain version; given CUDA tensors
it launches its kernel or raises (no fallback).  :func:`flash_attention` is
the differentiable entry point (:class:`FlashAttention`).
"""
from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path

import torch

from repro_torch.kernels.build import DTYPE_CODE, check_same, load, raise_on, stream
from repro_torch.kernels.ref import NEG_INF, repeat_kv

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "flash_attention.cu"
SUPPORTED_HEAD_DIMS = (32, 64, 128, 256)

#: Kernel launches per kernel name, counted by the wrappers where they
#: launch (plain-version calls on the CPU are not counted).
LAUNCHES = {"flash_fwd": 0, "flash_bwd_delta": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkdv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ----------------------------------------------------------------------
# Load
# ----------------------------------------------------------------------
_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: The library's entry points and their ``argtypes``.
SIGNATURES = {
    "flash_fwd": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _f, _i, _p],
    "flash_bwd_delta": [_p, _p, _p, _i, _i, _i, _i, _i, _p],
    "flash_bwd_dq": [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _f, _i, _p],
    "flash_bwd_dkdv": [_p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _f, _i,
                       _p],
    "flash_mma_occupancy": [_i, _i, _p],
}
_lib = None
_lib_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernels' shared library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load(SOURCE, SIGNATURES)
        return _lib


# ----------------------------------------------------------------------
# Checks shared by the wrappers
# ----------------------------------------------------------------------
def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on anything the kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,H,hd) and k, v (B,S,K,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError("the kernels take self-attention with aligned q/kv "
                         f"positions: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"H={H} not a multiple of K={k.shape[2]}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    check_same(q, k, v)
    check_aligned("q, k and v", q, k, v)


def check_aligned(names: str, *ts: torch.Tensor) -> None:
    """CUDA tensors must start on a 16-byte boundary: the kernels copy
    16-byte chunks, and a misaligned one would kill the CUDA context."""
    if ts[0].is_cuda and any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{names} must start on a 16-byte boundary (the flash "
                         "kernels copy 16-byte chunks)")


def _window_arg(window: int | None) -> int:
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return 0 if window is None else int(window)


# ----------------------------------------------------------------------
# Plain versions (float32 math, scores materialized)
# ----------------------------------------------------------------------
def _visible(S: int, causal: bool, window: int | None, device) -> torch.Tensor:
    pos = torch.arange(S, device=device)
    qp, kp = pos[:, None], pos[None, :]
    mask = torch.ones(S, S, dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    return mask


def _scores(q, k, causal, window):
    """Scaled, masked scores (B, H, S, S) in f32, the scaled q, the
    expanded k and the mask."""
    B, S, H, hd = q.shape
    qs = q.float() * (1.0 / math.sqrt(hd))
    kf = repeat_kv(k.float(), H // k.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    mask = _visible(S, causal, window, q.device)
    return s.masked_fill(~mask, NEG_INF), qs, kf, mask


def plain_fwd(q, k, v, causal=True, window=None, rounding="f32"):
    """(o in q's dtype, lse (B, H, S) f32): what ``flash_fwd`` computes.
    ``rounding`` other than ``"f32"`` emulates how the unnormalised
    probabilities exp(s - m) enter O = P V on the tensor cores
    (:func:`round_operand`), before the division by the float32 row sum;
    the kernels' check and the model use ``"f32"``."""
    s, _, _, mask = _scores(q, k, causal, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    lc = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    vf = repeat_kv(v.float(), q.shape[2] // v.shape[2])
    if rounding == "f32":
        o = torch.einsum("bhqk,bkhd->bqhd", p / lc, vf)
    else:
        o = torch.einsum("bhqk,bkhd->bqhd", round_operand(p, rounding), vf) \
            / lc.permute(0, 2, 1, 3)
    lse = (m + torch.log(lc)).squeeze(-1)
    return o.to(q.dtype).contiguous(), lse.contiguous()


def plain_bwd_delta(o, do):
    """delta = rowsum(dO * O) as (B, H, S) f32: ``flash_bwd_delta``."""
    return (o.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()


def sum_groups(partial: torch.Tensor, K: int) -> torch.Tensor:
    """Per-query-head partials (B, S, H, hd) summed over each group of
    H / K heads sharing a kv head: (B, S, K, hd).  Query head h belongs
    to kv head h // (H / K)."""
    B, S, H, hd = partial.shape
    return partial.view(B, S, K, H // K, hd).sum(3)


def round_operand(x: torch.Tensor, rounding: str) -> torch.Tensor:
    """P or dS as it enters a second product (O = P V, dV = P^T dO, ...):
    ``"f32"`` as it is, ``"bf16"`` rounded once to bfloat16, ``"split"`` as
    the bfloat16 pair hi = bf16(x), lo = bf16(x - hi) that the tensor-core
    kernels multiply in two products (hi + lo, exact in float32)."""
    if rounding == "f32":
        return x
    hi = x.to(torch.bfloat16).float()
    if rounding == "bf16":
        return hi
    if rounding == "split":
        return hi + (x - hi).to(torch.bfloat16).float()
    raise ValueError(f"rounding must be 'f32', 'bf16' or 'split', got {rounding!r}")


def plain_bwd(q, k, v, do, lse, delta, causal=True, window=None, rounding="f32"):
    """(dq, dk, dv) in the inputs' dtype: ``flash_bwd_dq`` and
    ``flash_bwd_dkdv`` together.  ``rounding`` emulates how P and dS enter
    the second products (:func:`round_operand`); the kernels' check and the
    model use ``"f32"``, the other two pin the tensor-core kernels' choice
    in the CPU tests."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    s, qs, kf, mask = _scores(q, k, causal, window)
    vf = repeat_kv(v.float(), H // K)
    dof = do.float()
    p = torch.exp(s - lse[..., None]) * mask
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    p, ds = round_operand(p, rounding), round_operand(ds, rounding)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * (1.0 / math.sqrt(hd))
    dk = sum_groups(torch.einsum("bhqk,bqhd->bkhd", ds, qs), K)
    dv = sum_groups(torch.einsum("bhqk,bqhd->bkhd", p, dof), K)
    return (dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


# ----------------------------------------------------------------------
# Wrappers: one per kernel
# ----------------------------------------------------------------------
def fwd(q, k, v, causal=True, window=None):
    """(o, lse).  ``flash_fwd`` on CUDA tensors, :func:`plain_fwd` on CPU."""
    check_inputs(q, k, v)
    w = _window_arg(window)
    if not q.is_cuda:
        return plain_fwd(q, k, v, causal, window)
    B, S, H, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    err = load_library().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, S, H, k.shape[2], hd, int(causal), w, 1.0 / math.sqrt(hd),
        DTYPE_CODE[q.dtype], stream())
    LAUNCHES["flash_fwd"] += 1
    raise_on(err, "flash_fwd")
    return o, lse


def bwd_delta(o, do):
    """delta (B, H, S) f32.  ``flash_bwd_delta`` on CUDA tensors."""
    if o.dim() != 4 or o.shape != do.shape:
        raise ValueError(f"o {tuple(o.shape)} and dO {tuple(do.shape)} must match")
    if o.shape[3] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {o.shape[3]} not in {SUPPORTED_HEAD_DIMS}")
    check_same(o, do)
    check_aligned("o and dO", o, do)
    if not o.is_cuda:
        return plain_bwd_delta(o, do)
    B, S, H, hd = o.shape
    delta = torch.empty(B, H, S, dtype=torch.float32, device=o.device)
    err = load_library().flash_bwd_delta(o.data_ptr(), do.data_ptr(), delta.data_ptr(),
                                         B, S, H, hd, DTYPE_CODE[o.dtype], stream())
    LAUNCHES["flash_bwd_delta"] += 1
    raise_on(err, "flash_bwd_delta")
    return delta


def _check_bwd(q, k, v, do, lse, delta):
    check_inputs(q, k, v)
    check_same(q, do)
    if do.shape != q.shape:
        raise ValueError("dO must have q's shape")
    check_aligned("dO", do)
    B, S, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, S) or t.dtype != torch.float32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B, H, S) float32 tensor")


def bwd_dq(q, k, v, do, lse, delta, causal=True, window=None):
    """dq.  ``flash_bwd_dq`` on CUDA tensors."""
    _check_bwd(q, k, v, do, lse, delta)
    w = _window_arg(window)
    if not q.is_cuda:
        return plain_bwd(q, k, v, do, lse, delta, causal, window)[0]
    B, S, H, hd = q.shape
    dq = torch.empty_like(q)
    err = load_library().flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), B, S, H, k.shape[2], hd, int(causal), w,
        1.0 / math.sqrt(hd), DTYPE_CODE[q.dtype], stream())
    LAUNCHES["flash_bwd_dq"] += 1
    raise_on(err, "flash_bwd_dq")
    return dq


def bwd_dkdv(q, k, v, do, lse, delta, causal=True, window=None):
    """(dk, dv).  ``flash_bwd_dkdv`` on CUDA tensors."""
    _check_bwd(q, k, v, do, lse, delta)
    w = _window_arg(window)
    if not q.is_cuda:
        return plain_bwd(q, k, v, do, lse, delta, causal, window)[1:]
    B, S, H, hd = q.shape
    K = k.shape[2]
    # bf16 with G = H / K > 1: one CTA per query head writes float32
    # partials (B, S, H, hd), summed here over the group (no atomics)
    partial = q.dtype == torch.bfloat16 and H != K
    if partial:
        dk = torch.empty(B, S, H, hd, dtype=torch.float32, device=q.device)
        dv = torch.empty_like(dk)
    else:
        dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = load_library().flash_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H, K, hd,
        int(causal), w, 1.0 / math.sqrt(hd), DTYPE_CODE[q.dtype], stream())
    LAUNCHES["flash_bwd_dkdv"] += 1
    raise_on(err, "flash_bwd_dkdv")
    if partial:
        dk, dv = sum_groups(dk, K).to(k.dtype), sum_groups(dv, K).to(v.dtype)
    return dk, dv


#: The bfloat16 tensor-core kernels, in the order of ``flash_mma_occupancy``.
MMA_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")


def occupancy(kernel: str, hd: int) -> dict:
    """Resources of the bfloat16 tensor-core kernel ``kernel`` (one of
    :data:`MMA_KERNELS`) at head dim ``hd``, as the CUDA runtime reports
    them: registers a thread, dynamic shared bytes, threads and CTAs per
    SM.  Launches nothing."""
    if kernel not in MMA_KERNELS:
        raise ValueError(f"kernel must be one of {MMA_KERNELS}, got {kernel!r}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    out = (ctypes.c_int * 4)()
    raise_on(load_library().flash_mma_occupancy(MMA_KERNELS.index(kernel), hd, out),
             "flash_mma_occupancy")
    return dict(zip(("registers", "smem_bytes", "threads", "ctas_per_sm"), out))


class FlashAttention(torch.autograd.Function):
    """Self-attention through the kernels; the backward recomputes the
    probabilities from the saved row logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = bwd_delta(o, do)
        dk, dv = bwd_dkdv(q, k, v, do, lse, delta, ctx.causal, ctx.window)
        dq = bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """q: (B, S, H, hd); k, v: (B, S, K, hd) with H % K == 0.  Returns
    (B, S, H, hd) in q's dtype; differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v, causal, window)
