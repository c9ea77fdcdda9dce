"""RWKV6 wkv scan for Hopper: forward and backward CUDA kernels.

Replaces the TPU kernel ``src/repro/kernels/wkv6.py::_wkv6_kernel``
(Pallas, forward only).  The kernels live in ``repro_torch/csrc/wkv6.cu``,
built at first use with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface (:mod:`repro_torch.kernels.build`), loaded with ``ctypes``
and launched on PyTorch's current stream.

They compute the reference's step recurrence (:func:`repro_torch.kernels.
ref.wkv6`), exact at any decay, and not the Pallas kernel's chunked
log-decay form, which overflows float32 once a 64-token block's decay
passes e^-88 (a per-token w below ~0.25).

What bounds them on this card: the function needs ~5 float32 operations
per state entry and step forward (~14 backward) over B·H (hd, hd) states,
so the CUDA cores' float32 rate (~20 us forward at B 2, S 1024, H 32,
hd 64), but only B·H dependent 1024-step chains.  The forward does 7: it
adds the u bonus per state entry, not as one (r . (u * k)) v_t per step.  A CTA owns 16 value columns of one head (the
columns of the state are independent), one thread per key channel holding
its 16 state entries in registers (the source's header has the detail).
The forward saves the float32 state every :data:`CHECKPOINT` steps; the
backward rebuilds each chunk's states from its checkpoint and walks them in
reverse, so it never divides by w (unstable as w -> 0) and never holds the
whole (B, H, S, hd, hd) state sequence.

Two wrappers, each with a launch counter in :data:`LAUNCHES` and a plain
PyTorch version beside it:

==============  ==============  ============================================
wrapper         kernel          plain version
==============  ==============  ============================================
:func:`fwd`     ``wkv6_fwd``    :func:`plain_fwd` (the reference's f32 scan,
                                with the checkpoints)
:func:`bwd`     ``wkv6_bwd``    :func:`plain_bwd` (the same chunked
                                reverse-time scan in torch, vectorised over
                                (b, h))
==============  ==============  ============================================

A wrapper given CPU tensors computes its plain version; given CUDA tensors
it launches its kernel or raises (no fallback).  :func:`wkv6` is the
differentiable entry point (:class:`WKV6`).  The sums over value columns
of dr, dk, dw and du are written per block of 16 columns and reduced by one
``sum(0)``: no atomics, deterministic.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import (DTYPE_CODE, check_f32, check_same, load, ptr,
                                       raise_on, stream)

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "wkv6.cu"
#: head dims the kernels take (one thread per key channel)
HEAD_DIMS = (32, 64)
#: value columns per CTA: the partials' leading axis is hd // COLUMN_BLOCK
COLUMN_BLOCK = 16
#: steps between the forward's saved states
CHECKPOINT = 64
#: the grid's second and third axes are the heads and the batch
MAX_GRID = 65_535

#: Kernel launches per kernel name, counted by the wrappers where they
#: launch (plain-version calls on the CPU are not counted).
LAUNCHES = {"wkv6_fwd": 0, "wkv6_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ----------------------------------------------------------------------
# Load
# ----------------------------------------------------------------------
_lib = None
_lib_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernels' shared library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            p, i = ctypes.c_void_p, ctypes.c_int
            _lib = load(SOURCE, {
                "wkv6_fwd": [p] * 9 + [i] * 5 + [p],
                "wkv6_bwd": [p] * 14 + [i] * 5 + [p],
            })
        return _lib


# ----------------------------------------------------------------------
# Checks
# ----------------------------------------------------------------------
def num_checkpoints(S: int) -> int:
    return -(-S // CHECKPOINT)


def check_inputs(r, k, v, w, u, state=None) -> None:
    """Raise on anything the kernels do not take."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"want r, k, v, w (B, S, H, hd) of one shape; got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, S, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported (one of {HEAD_DIMS})")
    if min(B, S, H) < 1 or max(B, H) > MAX_GRID:
        raise ValueError(f"(B, S, H) = {(B, S, H)}: each must be >= 1 and B, H <= {MAX_GRID}")
    check_same(r, k, v, w)
    check_f32("u", u, (H, hd), r.device)
    check_f32("state", state, (B, H, hd, hd), r.device)


# ----------------------------------------------------------------------
# Plain versions (float32 math)
# ----------------------------------------------------------------------
def plain_fwd(r, k, v, w, u, state=None, save_ckpt=False):
    """(out in r's dtype, s_last (B, H, hd, hd) f32, the checkpoints (B, H,
    NC, hd, hd) f32 -- the state before steps 0, 64, ... -- or None): what
    ``wkv6_fwd`` computes, by the reference's step."""
    return ref.wkv6_checkpointed(r, k, v, w, u, state, CHECKPOINT if save_ckpt else 0)


def plain_bwd(r, k, v, w, u, ckpt, dout, ds_last=None):
    """(dr, dk, dv, dw in r's dtype, du (H, hd) f32, ds0 (B, H, hd, hd) f32):
    the kernel's backward, vectorised over (b, h).  Chunk by chunk from the
    last, the states S_{t-1} are rebuilt from the chunk's checkpoint, then
    walked in reverse with the state cotangent G (G_{t-1} = w_t G_t + r_t
    do_t^T, from ``ds_last`` or 0)."""
    B, S, H, hd = r.shape
    rs, ks, vs, ws, ds = (t.float() for t in (r, k, v, w, dout))
    uf = u.float()
    g = torch.zeros(B, H, hd, hd, device=r.device) if ds_last is None else ds_last.float()
    dr, dk, dv, dw = (torch.empty(B, S, H, hd, device=r.device) for _ in range(4))
    du = torch.zeros(H, hd, device=r.device)
    for c in range(num_checkpoints(S) - 1, -1, -1):
        c0, c1 = c * CHECKPOINT, min((c + 1) * CHECKPOINT, S)
        prev = [ckpt[:, :, c]]
        for t in range(c0, c1 - 1):
            prev.append(ws[:, t, ..., None] * prev[-1]
                        + ks[:, t, ..., None] * vs[:, t, :, None, :])
        for t in range(c1 - 1, c0 - 1, -1):
            sp, rt, kt, vt, wt, dt = prev[t - c0], rs[:, t], ks[:, t], vs[:, t], ws[:, t], \
                ds[:, t]
            vdo = (vt * dt).sum(-1, keepdim=True)
            dr[:, t] = torch.einsum("bhij,bhj->bhi", sp, dt) + uf * kt * vdo
            dk[:, t] = torch.einsum("bhij,bhj->bhi", g, vt) + uf * rt * vdo
            dv[:, t] = torch.einsum("bhij,bhi->bhj", g, kt) \
                + (rt * uf * kt).sum(-1, keepdim=True) * dt
            dw[:, t] = (g * sp).sum(-1)
            du += (rt * kt * vdo).sum(0)
            g = wt[..., None] * g + rt[..., None] * dt[..., None, :]
    cast = (lambda t: t.to(r.dtype))  # noqa: E731
    return cast(dr), cast(dk), cast(dv), cast(dw), du, g


# ----------------------------------------------------------------------
# Wrappers: one per kernel
# ----------------------------------------------------------------------
def fwd(r, k, v, w, u, state=None, save_ckpt=False):
    """(out, s_last, checkpoints or None).  ``wkv6_fwd`` on CUDA tensors,
    :func:`plain_fwd` on CPU tensors."""
    check_inputs(r, k, v, w, u, state)
    if not r.is_cuda:
        return plain_fwd(r, k, v, w, u, state, save_ckpt)
    B, S, H, hd = r.shape
    out = torch.empty_like(r)
    s_last = torch.empty(B, H, hd, hd, dtype=torch.float32, device=r.device)
    ckpt = torch.empty(B, H, num_checkpoints(S), hd, hd, dtype=torch.float32,
                       device=r.device) if save_ckpt else None
    err = load_library().wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), ptr(state),
        out.data_ptr(), s_last.data_ptr(), ptr(ckpt), B, S, H, hd, DTYPE_CODE[r.dtype],
        stream())
    LAUNCHES["wkv6_fwd"] += 1
    raise_on(err, "wkv6_fwd")
    return out, s_last, ckpt


def bwd(r, k, v, w, u, ckpt, dout, ds_last=None):
    """(dr, dk, dv, dw, du, ds0).  ``wkv6_bwd`` on CUDA tensors,
    :func:`plain_bwd` on CPU tensors."""
    check_inputs(r, k, v, w, u)
    check_same(r, dout)
    if dout.shape != r.shape:
        raise ValueError("dout must have r's shape")
    if ckpt is None:
        raise ValueError("the backward needs the forward's f32 checkpoints")
    B, S, H, hd = r.shape
    check_f32("ckpt", ckpt, (B, H, num_checkpoints(S), hd, hd), r.device)
    check_f32("ds_last", ds_last, (B, H, hd, hd), r.device)
    if not r.is_cuda:
        return plain_bwd(r, k, v, w, u, ckpt, dout, ds_last)
    nj = hd // COLUMN_BLOCK
    dr_part, dk_part, dw_part = (torch.empty(nj, B, S, H, hd, dtype=torch.float32,
                                             device=r.device) for _ in range(3))
    dv = torch.empty_like(r)
    du_part = torch.empty(nj, B, H, hd, dtype=torch.float32, device=r.device)
    ds0 = torch.empty(B, H, hd, hd, dtype=torch.float32, device=r.device)
    err = load_library().wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), ckpt.data_ptr(),
        dout.data_ptr(), ptr(ds_last), dr_part.data_ptr(), dk_part.data_ptr(),
        dw_part.data_ptr(), dv.data_ptr(), du_part.data_ptr(), ds0.data_ptr(), B, S, H, hd,
        DTYPE_CODE[r.dtype], stream())
    LAUNCHES["wkv6_bwd"] += 1
    raise_on(err, "wkv6_bwd")
    cast = (lambda t: t.sum(0).to(r.dtype))  # noqa: E731
    return cast(dr_part), cast(dk_part), dv, cast(dw_part), du_part.sum((0, 1)), ds0


class WKV6(torch.autograd.Function):
    """The scan through the kernels; the forward saves the f32 checkpoints
    for the backward only when an input needs a gradient."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        r, k, v, w = (t.contiguous() for t in (r, k, v, w))
        save = any(ctx.needs_input_grad)
        out, s_last, ckpt = fwd(r, k, v, w, u, state, save_ckpt=save)
        if save:
            ctx.save_for_backward(r, k, v, w, u, ckpt)
            ctx.has_state = state is not None
        return out, s_last

    @staticmethod
    def backward(ctx, dout, ds_last):
        r, k, v, w, u, ckpt = ctx.saved_tensors
        dr, dk, dv, dw, du, ds0 = bwd(r, k, v, w, u, ckpt, dout.contiguous(),
                                      ds_last.contiguous())
        return dr, dk, dv, dw, du, (ds0 if ctx.has_state else None)


def wkv6(r, k, v, w, u, state=None):
    """r, k, v, w: (B, S, H, hd) float32 or bfloat16 (hd 32 or 64); u (H, hd)
    f32; state (B, H, hd, hd) f32 or None.  Returns (out (B, S, H, hd) in r's
    dtype, final state (B, H, hd, hd) f32); differentiable in every input."""
    return WKV6.apply(r, k, v, w, u, state)
