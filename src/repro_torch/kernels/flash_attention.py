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
``flash_bwd_delta`` only moves bytes: it reads 16 bytes of dO a lane and
a float32 O beside it (for bfloat16, the forward's ``o32``).  With more than one query head per kv head,
``flash_bwd_dkdv`` writes float32 partials per query head and
:func:`bwd_dkdv` sums them over the group (:func:`sum_groups`).  float32
keeps the FMA kernels: TF32 would not meet its 2e-4 check.

q and k may differ in length (``Sq != Skv``: cross-attention, down to one
query token in decode) only without a causal mask or window: the
reference has no causal or windowed cross-attention, and the wrappers
raise on one.  The reference sends such calls, and the encoder's
bidirectional ones, to ``ref.attention``; the port computes the same
function with these kernels.

Each kernel is a PyTorch operator, ``torch.ops.repro_torch.<kernel>``
(:class:`repro_torch.kernels.build.Operators`): its CUDA implementation
launches the kernel and counts the launch; its shape function allocates the
same outputs (lse, o32, dk/dv's float32 partials), launches nothing and
counts nothing; its FLOP formula is :func:`repro_torch.kernels.cost.
flash_flops`.  A wrapper given CPU tensors computes its plain version; given
CUDA tensors it launches its kernel or raises (no fallback); given fake
tensors (``FakeTensorMode``, on CUDA or the meta device) or meta tensors, a
shape-only lowering, it runs the shape function.  :func:`flash_attention`
is the differentiable entry point (:class:`FlashAttention`).
"""
from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.build import (DTYPE_CODE, Operators, check_aligned, check_same, load,
                                       on_kernel_path, ptr, raise_on, stream)
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
    "flash_fwd": [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _f, _i, _p],
    "flash_bwd_delta": [_p, _p, _p, _i, _i, _i, _i, _i, _p],
    "flash_bwd_dq": [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _f, _i, _p],
    "flash_bwd_dkdv": [_p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _f,
                       _i, _p],
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
def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                 window: int | None = None) -> None:
    """Raise on anything the kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,Sq,H,hd) and k, v (B,Skv,K,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in batch or "
                         "head dim")
    if k.shape[1] != S and (causal or window is not None):
        raise ValueError("q and kv lengths differ (cross-attention): the kernels take "
                         f"that only with causal=False and no window; q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, causal={causal}, window={window}")
    if H % k.shape[2]:
        raise ValueError(f"H={H} not a multiple of K={k.shape[2]}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    check_same(q, k, v)


def _window_arg(window: int | None) -> int:
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return 0 if window is None else int(window)


# ----------------------------------------------------------------------
# Plain versions (float32 math, scores materialized)
# ----------------------------------------------------------------------
def _visible(Sq: int, Skv: int, causal: bool, window: int | None, device) -> torch.Tensor:
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    return mask


def _scores(q, k, causal, window):
    """Scaled, masked scores (B, H, Sq, Skv) in f32, the scaled q, the
    expanded k and the mask."""
    B, S, H, hd = q.shape
    qs = q.float() * (1.0 / math.sqrt(hd))
    kf = repeat_kv(k.float(), H // k.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    mask = _visible(S, k.shape[1], causal, window, q.device)
    return s.masked_fill(~mask, NEG_INF), qs, kf, mask


def plain_fwd(q, k, v, causal=True, window=None, rounding="f32", out_f32=False):
    """(o in q's dtype, lse (B, H, Sq) f32): what ``flash_fwd`` computes;
    with ``out_f32`` also o in float32 before its rounding (:func:`fwd`).
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
    out = (o.to(q.dtype).contiguous(), lse.contiguous())
    return (*out, o.contiguous()) if out_f32 else out


def plain_bwd_delta(o, do):
    """delta = rowsum(dO * O) as (B, H, S) f32: ``flash_bwd_delta`` (which
    takes O in float32)."""
    return (o.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()


def sum_groups(partial: torch.Tensor, K: int) -> torch.Tensor:
    """Per-query-head partials (B, Skv, H, hd) summed over each group of
    H / K heads sharing a kv head: (B, Skv, K, hd).  Query head h belongs
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
# The kernels as operators (``torch.ops.repro_torch.flash_*``): the CUDA
# implementation launches, the shape function allocates the same outputs
# ----------------------------------------------------------------------
def _fwd_outputs(q, out_f32):
    """o, lse (B, H, S) f32, and o32: q's shape in float32 where a bfloat16
    forward keeps it, else empty (a float32 o is its own o32)."""
    B, S, H, _ = q.shape
    keep = out_f32 and q.dtype != torch.float32
    return (torch.empty_like(q), q.new_empty((B, H, S), dtype=torch.float32),
            q.new_empty(q.shape if keep else (0,), dtype=torch.float32))


def _fwd_cuda(q, k, v, causal, window, out_f32):
    check_aligned("q, k and v", q, k, v)
    o, lse, o32 = _fwd_outputs(q, out_f32)
    B, S, H, hd = q.shape
    err = load_library().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        ptr(o32) if o32.numel() else None, B, S, k.shape[1], H, k.shape[2], hd, int(causal),
        window, 1.0 / math.sqrt(hd), DTYPE_CODE[q.dtype], stream())
    LAUNCHES["flash_fwd"] += 1
    raise_on(err, "flash_fwd")
    return o, lse, o32


def _delta_cuda(o32, do):
    check_aligned("o32 and dO", o32, do)
    B, S, H, hd = o32.shape
    delta = o32.new_empty((B, H, S))
    err = load_library().flash_bwd_delta(o32.data_ptr(), do.data_ptr(), delta.data_ptr(),
                                         B, S, H, hd, DTYPE_CODE[do.dtype], stream())
    LAUNCHES["flash_bwd_delta"] += 1
    raise_on(err, "flash_bwd_delta")
    return delta


def _delta_fake(o32, do):
    B, S, H, _ = o32.shape
    return o32.new_empty((B, H, S))


def _dq_cuda(q, k, v, do, lse, delta, causal, window):
    check_aligned("q, k, v and dO", q, k, v, do)
    B, S, H, hd = q.shape
    dq = torch.empty_like(q)
    err = load_library().flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), B, S, k.shape[1], H, k.shape[2], hd, int(causal),
        window, 1.0 / math.sqrt(hd), DTYPE_CODE[q.dtype], stream())
    LAUNCHES["flash_bwd_dq"] += 1
    raise_on(err, "flash_bwd_dq")
    return dq


def _dkdv_outputs(q, k):
    """dk, dv: k's shape and dtype, or, for bfloat16 with G = H / K > 1,
    float32 partials (B, Skv, H, hd), one CTA per query head (no atomics),
    which :func:`bwd_dkdv` sums over each group."""
    if q.dtype == torch.bfloat16 and q.shape[2] != k.shape[2]:
        dk = k.new_empty((k.shape[0], k.shape[1], q.shape[2], k.shape[3]), dtype=torch.float32)
        return dk, torch.empty_like(dk)
    return torch.empty_like(k), torch.empty_like(k)


def _dkdv_cuda(q, k, v, do, lse, delta, causal, window):
    check_aligned("q, k, v and dO", q, k, v, do)
    B, S, H, hd = q.shape
    dk, dv = _dkdv_outputs(q, k)
    err = load_library().flash_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, k.shape[1], H, k.shape[2], hd,
        int(causal), window, 1.0 / math.sqrt(hd), DTYPE_CODE[q.dtype], stream())
    LAUNCHES["flash_bwd_dkdv"] += 1
    raise_on(err, "flash_bwd_dkdv")
    return dk, dv


def _flops(name):
    """The FLOP formula of kernel ``name`` (:func:`repro_torch.kernels.cost.
    flash_flops`) over its arguments, tensors given as shapes."""
    def formula(*args, out_shape=None, **_):
        if name == "flash_bwd_delta":   # (o32, dO)
            B, S, H, hd = args[0]
            return int(cost.flash_flops(B, S, S, H, hd, False, None)[name])
        (B, S, H, hd), k = args[:2]
        causal, window = args[3:5] if name == "flash_fwd" else args[6:8]
        return int(cost.flash_flops(B, S, k[1], H, hd, causal, window or None)[name])
    return formula


_OPS = Operators(__name__)
_MASK = "bool causal, int window"
_fwd_op = _OPS.define(f"flash_fwd(Tensor q, Tensor k, Tensor v, {_MASK}, bool out_f32) "
                      "-> (Tensor, Tensor, Tensor)", _fwd_cuda,
                      lambda q, k, v, causal, window, out_f32: _fwd_outputs(q, out_f32),
                      _flops("flash_fwd"))
_delta_op = _OPS.define("flash_bwd_delta(Tensor o32, Tensor do) -> Tensor", _delta_cuda,
                        _delta_fake, _flops("flash_bwd_delta"))
_BWD = f"Tensor q, Tensor k, Tensor v, Tensor do, Tensor lse, Tensor delta, {_MASK}"
_dq_op = _OPS.define(f"flash_bwd_dq({_BWD}) -> Tensor", _dq_cuda,
                     lambda q, *_: torch.empty_like(q), _flops("flash_bwd_dq"))
_dkdv_op = _OPS.define(f"flash_bwd_dkdv({_BWD}) -> (Tensor, Tensor)", _dkdv_cuda,
                       lambda q, k, *_: _dkdv_outputs(q, k), _flops("flash_bwd_dkdv"))


# ----------------------------------------------------------------------
# Wrappers: one per kernel
# ----------------------------------------------------------------------
def fwd(q, k, v, causal=True, window=None, out_f32=False):
    """(o, lse), with ``out_f32`` (o, lse, o32): o32 is the output in
    float32 before its rounding to q's dtype, which the backward's delta
    reads (for float32 inputs, o itself).  ``flash_fwd`` on CUDA tensors
    (its shape function on meta ones), :func:`plain_fwd` on CPU."""
    check_inputs(q, k, v, causal, window)
    w = _window_arg(window)
    if not on_kernel_path(q):
        return plain_fwd(q, k, v, causal, window, out_f32=out_f32)
    o, lse, o32 = _fwd_op(q, k, v, bool(causal), w, out_f32)
    if not out_f32:
        return o, lse
    return o, lse, (o if q.dtype == torch.float32 else o32)


def bwd_delta(o32, do):
    """delta (B, H, S) f32 from the forward's float32 output o32
    (:func:`fwd` with ``out_f32``) and dO (float32 or bfloat16).
    ``flash_bwd_delta`` on CUDA tensors."""
    if o32.dim() != 4 or o32.shape != do.shape:
        raise ValueError(f"o32 {tuple(o32.shape)} and dO {tuple(do.shape)} must match")
    if o32.shape[3] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {o32.shape[3]} not in {SUPPORTED_HEAD_DIMS}")
    if o32.dtype != torch.float32:
        raise ValueError(f"delta reads the forward's float32 output (fwd(..., out_f32=True)), "
                         f"got {o32.dtype}")
    check_same(o32)
    check_same(do)
    if o32.device != do.device:
        raise ValueError("inputs must share one device")
    if not on_kernel_path(o32):
        return plain_bwd_delta(o32, do)
    return _delta_op(o32, do)


def _check_bwd(q, k, v, do, lse, delta, causal, window):
    check_inputs(q, k, v, causal, window)
    check_same(q, do)
    if do.shape != q.shape:
        raise ValueError("dO must have q's shape")
    B, S, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, S) or t.dtype != torch.float32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B, H, S) float32 tensor")


def bwd_dq(q, k, v, do, lse, delta, causal=True, window=None):
    """dq.  ``flash_bwd_dq`` on CUDA tensors."""
    _check_bwd(q, k, v, do, lse, delta, causal, window)
    w = _window_arg(window)
    if not on_kernel_path(q):
        return plain_bwd(q, k, v, do, lse, delta, causal, window)[0]
    return _dq_op(q, k, v, do, lse, delta, bool(causal), w)


def bwd_dkdv(q, k, v, do, lse, delta, causal=True, window=None):
    """(dk, dv).  ``flash_bwd_dkdv`` on CUDA tensors."""
    _check_bwd(q, k, v, do, lse, delta, causal, window)
    w = _window_arg(window)
    if not on_kernel_path(q):
        return plain_bwd(q, k, v, do, lse, delta, causal, window)[1:]
    dk, dv = _dkdv_op(q, k, v, do, lse, delta, bool(causal), w)
    if dk.dtype != k.dtype:   # the bf16 per-query-head partials
        K = k.shape[2]
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
    """Attention through the kernels; the backward recomputes the
    probabilities from the saved row logsumexp.  Where a gradient is wanted
    the forward also keeps its output in float32 (o32), and delta = rowsum(dO
    * O) reads that: from the output rounded to bfloat16, dq in the short
    causal rows would be off the float32 reference by up to ~1e-2."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, keep_f32):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if keep_f32:
            o, lse, o32 = fwd(q, k, v, causal, window, out_f32=True)
        else:
            (o, lse), o32 = fwd(q, k, v, causal, window), None
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o32, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = bwd_delta(o32, do)
        dk, dv = bwd_dkdv(q, k, v, do, lse, delta, ctx.causal, ctx.window)
        dq = bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd) with H % K == 0, and Sq ==
    Skv unless ``causal`` is False and there is no window.  Returns (B, Sq,
    H, hd) in q's dtype; differentiable in q, k and v."""
    keep_f32 = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return FlashAttention.apply(q, k, v, causal, window, keep_f32)
