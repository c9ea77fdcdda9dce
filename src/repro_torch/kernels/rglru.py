"""RG-LRU scan for Hopper: forward and backward CUDA kernels.

Replaces the TPU kernel ``src/repro/kernels/rglru.py::_rglru_kernel``
(Pallas, forward only).  The kernels live in ``repro_torch/csrc/rglru.cu``,
built at first use with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface (:mod:`repro_torch.kernels.build`), loaded with
``ctypes`` and launched on PyTorch's current stream.

What bounds them on this card: the recurrence is elementwise over (batch,
width) and serial over time, so bytes bound its work (~19 us forward and
~28 us backward at B 2, S 1024, W 2560 in bf16), but only B·W lanes can run
at once, each a dependent chain of S steps, so latency bounds it in fact.
The design runs one thread per lane in one-warp CTAs, to spread the few
lanes over every SM, and holds a tile of time steps in registers, loading
the next tile before the current tile's chain (the source's header has the
detail).  The backward reads the float32 state sequence the forward saved,
so it never divides by ``a`` (unstable as a -> 0) or reads back the
rounded output.

Two wrappers, each with a launch counter in :data:`LAUNCHES` and a plain
PyTorch version beside it:

==============  ==============  ============================================
wrapper         kernel          plain version
==============  ==============  ============================================
:func:`fwd`     ``rglru_fwd``   :func:`plain_fwd` (the reference's f32 scan)
:func:`bwd`     ``rglru_bwd``   :func:`plain_bwd` (the same reverse-time
                                scan in torch, vectorised over (b, w))
==============  ==============  ============================================

A wrapper given CPU tensors computes its plain version; given CUDA tensors
it launches its kernel or raises (no fallback).  :func:`rglru` is the
differentiable entry point (:class:`RGLRU`).  dlam is reduced over time in
each thread and over the batch by one ``sum(0)`` of the kernel's (B, W)
partials, so no atomics are used and the result is deterministic.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import (DTYPE_CODE, check_f32, check_same, load, ptr,
                                       raise_on, stream)

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "rglru.cu"
#: the grid's second axis is the batch
MAX_BATCH = 65_535

#: Kernel launches per kernel name, counted by the wrappers where they
#: launch (plain-version calls on the CPU are not counted).
LAUNCHES = {"rglru_fwd": 0, "rglru_bwd": 0}


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
                "rglru_fwd": [p, p, p, p, p, p, p, p, i, i, i, i, p],
                "rglru_bwd": [p, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, p],
            })
        return _lib


# ----------------------------------------------------------------------
# Checks
# ----------------------------------------------------------------------
def check_inputs(x, r_gate, i_gate, lam, h0=None) -> None:
    """Raise on anything the kernels do not take."""
    if x.dim() != 3 or r_gate.shape != x.shape or i_gate.shape != x.shape:
        raise ValueError(f"want x, r_gate, i_gate (B, S, W) of one shape; got "
                         f"{tuple(x.shape)}, {tuple(r_gate.shape)}, {tuple(i_gate.shape)}")
    B, S, W = x.shape
    if min(B, S, W) < 1 or B > MAX_BATCH:
        raise ValueError(f"(B, S, W) = {(B, S, W)}: each must be >= 1 and B <= {MAX_BATCH}")
    check_same(x, r_gate, i_gate)
    check_f32("lam", lam, (W,), x.device)
    check_f32("h0", h0, (B, W), x.device)


# ----------------------------------------------------------------------
# Plain versions (float32 math)
# ----------------------------------------------------------------------
def plain_fwd(x, r_gate, i_gate, lam, h0=None, save_states=False):
    """(out in x's dtype, h_last (B, W) f32, the f32 states (B, S, W) or
    None): what ``rglru_fwd`` computes."""
    states, h = ref.rglru_states(x, r_gate, i_gate, lam, h0)
    return states.to(x.dtype), h, (states if save_states else None)


def plain_bwd(x, r_gate, i_gate, lam, h0, states, dout, dh_last=None):
    """(dx, dr, di in x's dtype, dlam (W,) f32, dh0 (B, W) f32): the
    kernel's reverse-time scan, vectorised over (b, w)."""
    B, S, W = x.shape
    lamf = lam.float()
    log_a_base = -ref.RGLRU_C * ref.softplus(lamf)
    dbase_dlam = -ref.RGLRU_C * torch.sigmoid(lamf)
    xs, rs, gs, ds = (t.float() for t in (x, r_gate, i_gate, dout))
    h_init = torch.zeros(B, W, device=x.device) if h0 is None else h0.float()
    carry = torch.zeros(B, W, device=x.device) if dh_last is None else dh_last.float()
    dlam = torch.zeros(B, W, device=x.device)
    dx, dr, di = (torch.empty(B, S, W, device=x.device) for _ in range(3))
    for t in range(S - 1, -1, -1):
        sr, si = torch.sigmoid(rs[:, t]), torch.sigmoid(gs[:, t])
        log_a = log_a_base * sr
        a, e2 = torch.exp(log_a), torch.exp(2.0 * log_a)
        one_minus = 1.0 - e2
        mult = torch.sqrt(torch.clamp(one_minus, min=1e-12))
        dh = ds[:, t] + carry
        dgated = dh * mult
        h_prev = states[:, t - 1] if t > 0 else h_init
        dlog_a = dh * h_prev * a - torch.where(one_minus > 1e-12,
                                               dh * si * xs[:, t] * e2 / mult, 0.0)
        carry = a * dh
        dx[:, t] = dgated * si
        di[:, t] = dgated * xs[:, t] * si * (1.0 - si)
        dr[:, t] = dlog_a * log_a_base * sr * (1.0 - sr)
        dlam += dlog_a * sr * dbase_dlam
    cast = (lambda t: t.to(x.dtype))  # noqa: E731
    return cast(dx), cast(dr), cast(di), dlam.sum(0), carry


# ----------------------------------------------------------------------
# Wrappers: one per kernel
# ----------------------------------------------------------------------
def fwd(x, r_gate, i_gate, lam, h0=None, save_states=False):
    """(out, h_last, states or None).  ``rglru_fwd`` on CUDA tensors,
    :func:`plain_fwd` on CPU tensors."""
    check_inputs(x, r_gate, i_gate, lam, h0)
    if not x.is_cuda:
        return plain_fwd(x, r_gate, i_gate, lam, h0, save_states)
    B, S, W = x.shape
    out = torch.empty_like(x)
    h_last = torch.empty(B, W, dtype=torch.float32, device=x.device)
    states = torch.empty(B, S, W, dtype=torch.float32, device=x.device) \
        if save_states else None
    err = load_library().rglru_fwd(
        x.data_ptr(), r_gate.data_ptr(), i_gate.data_ptr(), lam.data_ptr(), ptr(h0),
        out.data_ptr(), h_last.data_ptr(), ptr(states), B, S, W, DTYPE_CODE[x.dtype],
        stream())
    LAUNCHES["rglru_fwd"] += 1
    raise_on(err, "rglru_fwd")
    return out, h_last, states


def bwd(x, r_gate, i_gate, lam, h0, states, dout, dh_last=None):
    """(dx, dr, di, dlam, dh0).  ``rglru_bwd`` on CUDA tensors,
    :func:`plain_bwd` on CPU tensors."""
    check_inputs(x, r_gate, i_gate, lam, h0)
    check_same(x, dout)
    if dout.shape != x.shape:
        raise ValueError("dout must have x's shape")
    B, S, W = x.shape
    check_f32("states", states, (B, S, W), x.device)
    check_f32("dh_last", dh_last, (B, W), x.device)
    if states is None:
        raise ValueError("the backward needs the forward's f32 states")
    if not x.is_cuda:
        return plain_bwd(x, r_gate, i_gate, lam, h0, states, dout, dh_last)
    dx, dr, di = (torch.empty_like(x) for _ in range(3))
    dlam_part = torch.empty(B, W, dtype=torch.float32, device=x.device)
    dh0 = torch.empty(B, W, dtype=torch.float32, device=x.device)
    err = load_library().rglru_bwd(
        x.data_ptr(), r_gate.data_ptr(), i_gate.data_ptr(), lam.data_ptr(), ptr(h0),
        states.data_ptr(), dout.data_ptr(), ptr(dh_last), dx.data_ptr(), dr.data_ptr(),
        di.data_ptr(), dlam_part.data_ptr(), dh0.data_ptr(), B, S, W,
        DTYPE_CODE[x.dtype], stream())
    LAUNCHES["rglru_bwd"] += 1
    raise_on(err, "rglru_bwd")
    return dx, dr, di, dlam_part.sum(0), dh0


class RGLRU(torch.autograd.Function):
    """The scan through the kernels; the forward saves the f32 states for
    the backward only when an input needs a gradient."""

    @staticmethod
    def forward(ctx, x, r_gate, i_gate, lam, h0):
        x, r_gate, i_gate = x.contiguous(), r_gate.contiguous(), i_gate.contiguous()
        save = any(ctx.needs_input_grad)
        out, h_last, states = fwd(x, r_gate, i_gate, lam, h0, save_states=save)
        if save:
            ctx.save_for_backward(x, r_gate, i_gate, lam, h0, states)
        return out, h_last

    @staticmethod
    def backward(ctx, dout, dh_last):
        x, r_gate, i_gate, lam, h0, states = ctx.saved_tensors
        dx, dr, di, dlam, dh0 = bwd(x, r_gate, i_gate, lam, h0, states,
                                    dout.contiguous(), dh_last.contiguous())
        return dx, dr, di, dlam, (dh0 if h0 is not None else None)


def rglru(x, r_gate, i_gate, lam, h0=None):
    """x, r_gate, i_gate: (B, S, W) float32 or bfloat16; lam (W,) f32; h0
    (B, W) f32 or None.  Returns (out (B, S, W) in x's dtype, h_final (B, W)
    f32); differentiable in every input."""
    return RGLRU.apply(x, r_gate, i_gate, lam, h0)
