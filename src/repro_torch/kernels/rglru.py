"""RG-LRU scan for Hopper: forward and backward CUDA kernels, as a
chunk-parallel scan over time.

Replaces the TPU kernel ``src/repro/kernels/rglru.py::_rglru_kernel``
(Pallas, forward only).  The kernels live in ``repro_torch/csrc/rglru.cu``,
built at first use with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface (:mod:`repro_torch.kernels.build`), loaded with
``ctypes`` and launched on PyTorch's current stream.

What bounds them on this card: the recurrence h_t = a_t h_{t-1} + b_t is
elementwise over (batch, width) and serial over time, so bytes bound its
work (~19 us forward and ~28 us backward at B 2, S 1024, W 2560 in bf16),
but a step scan has only B·W dependent chains of S steps, too few loads in
flight to stream.  The decay is a per-lane scalar, so the design cuts time
into chunks of :data:`CHUNK` steps and runs up to three kernels per
wrapper call (the source's header has the detail):

1. per (b, lane, chunk), in parallel: the chunk's local end value from
   zero and its decay product A_c = prod a_t (forward: the state U_c;
   backward: the carry V_c passed down in reverse time);
2. per lane, sequential over the chunks only: h_start(c+1) = A_c h_start(c)
   + U_c from h0 (forward), carry_end(c-1) = A_c carry_end(c) + V_c from
   dh_last (backward);
3. per (b, lane, chunk), in parallel: the step recurrence from the
   chunk's start, writing out and the f32 states (forward); the reverse walk
   from the chunk's end carry, writing dx, dr, di and a dlam partial per
   chunk (backward).

A sequence of at most one chunk runs phase 3 alone.  Chunks of 32 steps
and register tiles of 4 steps keep 20-40 warps an SM busy, enough to hide
the latency of each step's gate arithmetic: on an NVIDIA H100 80GB HBM3 at
700.00 W, recurrentgemma-2b's shape takes ~0.06 ms forward and ~0.075 ms
backward against bounds of 0.019 and 0.028 ms (``PERF.md`` has the
table).  Only products of a_t are taken in the chunk algebra, so a -> 1
and decay products that underflow to 0 stay exact.  The backward reads the float32 state sequence
the forward saved, so it never divides by ``a`` (unstable as a -> 0) or
reads back the rounded output.

:func:`chunked_fwd` and :func:`chunked_bwd` emulate the three phases in
PyTorch, vectorised over chunks; the CPU tests hold them to the JAX
reference.

Two wrappers, each with a launch counter in :data:`LAUNCHES` (one count
per call, for its CUDA launches) and a plain PyTorch version beside it:

==============  ==============  ============================================
wrapper         kernel          plain version
==============  ==============  ============================================
:func:`fwd`     ``rglru_fwd``   :func:`plain_fwd` (the reference's f32 scan)
:func:`bwd`     ``rglru_bwd``   :func:`plain_bwd` (the same reverse-time
                                scan in torch, vectorised over (b, w))
==============  ==============  ============================================

Each wrapper's kernel is a PyTorch operator, ``torch.ops.repro_torch.
rglru_fwd`` / ``rglru_bwd`` (:class:`repro_torch.kernels.build.Operators`):
its CUDA implementation launches and counts; its shape function allocates
the same outputs and scratch (the states, the chunk buffer, dlam's
partials) and launches nothing; its FLOP formula is :func:`repro_torch.
kernels.cost.rglru_flops`.  A wrapper given CPU tensors computes its plain
version; given CUDA tensors it launches its kernels or raises (no
fallback); given fake or meta tensors (a shape-only lowering) it runs the
shape function.  :func:`rglru` is the differentiable entry point
(:class:`RGLRU`).  dlam is reduced over each
chunk's steps in the thread and over the chunks and the batch by one
``sum`` of the kernel's (NC, B, W) partials, so no atomics are used and the
result is deterministic.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import cost, ref
from repro_torch.kernels.build import (DTYPE_CODE, Operators, check_f32, check_same, load,
                                       on_kernel_path, ptr, raise_on, stream)

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "rglru.cu"
#: steps per chunk (``CK`` in the source)
CHUNK = 32
#: the grid's second and third axes are the chunks and the batch
MAX_GRID = 65_535

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
                "rglru_fwd": [p] * 9 + [i] * 4 + [p],
                "rglru_bwd": [p] * 14 + [i] * 4 + [p],
                "rglru_occupancy": [i, p],
            })
        return _lib


# ----------------------------------------------------------------------
# Checks
# ----------------------------------------------------------------------
def num_chunks(S: int) -> int:
    return -(-S // CHUNK)


def check_inputs(x, r_gate, i_gate, lam, h0=None) -> None:
    """Raise on anything the kernels do not take."""
    if x.dim() != 3 or r_gate.shape != x.shape or i_gate.shape != x.shape:
        raise ValueError(f"want x, r_gate, i_gate (B, S, W) of one shape; got "
                         f"{tuple(x.shape)}, {tuple(r_gate.shape)}, {tuple(i_gate.shape)}")
    B, S, W = x.shape
    if min(B, S, W) < 1 or max(B, num_chunks(S)) > MAX_GRID:
        raise ValueError(f"(B, S, W) = {(B, S, W)}: each must be >= 1, B <= {MAX_GRID} "
                         f"and S <= {MAX_GRID * CHUNK}")
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
# The kernels' three phases in PyTorch (float32 math), vectorised over chunks
# ----------------------------------------------------------------------
def _gates(x, r_gate, i_gate, lam):
    """The kernels' ``gates()`` over (B, S, W): a, b = mult * (sigmoid(i) *
    x), and the backward's sigmoid(r), sigmoid(i), exp(2 log_a), mult and
    whether the floor was taken, all float32."""
    base = -ref.RGLRU_C * ref.softplus(lam.float())
    sr, si = torch.sigmoid(r_gate.float()), torch.sigmoid(i_gate.float())
    log_a = base * sr
    e2 = torch.exp(2.0 * log_a)
    one_minus = 1.0 - e2
    mult = torch.sqrt(torch.clamp(one_minus, min=1e-12))
    return dict(a=torch.exp(log_a), b=mult * (si * x.float()), sr=sr, si=si, e2=e2,
                mult=mult, floored=~(one_minus > 1e-12))


def _chunks(t: torch.Tensor, fill) -> torch.Tensor:
    """(B, S, W) -> (B, NC, CHUNK, W), the ragged last chunk padded with
    ``fill``: a padded step with a = 1 and b = 0 (dout = 0 backward) leaves
    every state and carry exactly as it is."""
    B, S, W = t.shape
    nc = num_chunks(S)
    t = torch.nn.functional.pad(t, (0, 0, 0, nc * CHUNK - S), value=fill)
    return t.reshape(B, nc, CHUNK, W)


def _unchunk(t: torch.Tensor, S: int) -> torch.Tensor:
    """(B, NC, CHUNK, W) -> (B, S, W)."""
    B, nc, C, W = t.shape
    return t.reshape(B, nc * C, W)[:, :S]


def chunked_fwd(x, r_gate, i_gate, lam, h0=None):
    """(out in x's dtype, h_last (B, W), the states (B, S, W), the chunk
    starts (B, NC, W): the state before steps 0, CHUNK, ...), all f32 but out:
    what ``rglru_fwd``'s kernels compute, phase by phase.  Used by the tests
    only."""
    B, S, W = x.shape
    g = _gates(x, r_gate, i_gate, lam)
    a, b = _chunks(g["a"], 1.0), _chunks(g["b"], 0.0)
    u, A = torch.zeros_like(a[:, :, 0]), torch.ones_like(a[:, :, 0])   # 1.
    for s in range(CHUNK):
        u = a[:, :, s] * u + b[:, :, s]
        A = A * a[:, :, s]
    y = x.new_zeros(B, W, dtype=torch.float32) if h0 is None else h0.float()   # 2.
    starts = [y]
    for c in range(a.shape[1] - 1):
        y = A[:, c] * y + u[:, c]
        starts.append(y)
    starts = torch.stack(starts, 1)
    h, states = starts, []                                             # 3.
    for s in range(CHUNK):
        h = a[:, :, s] * h + b[:, :, s]
        states.append(h)
    states = _unchunk(torch.stack(states, 2), S)
    return states.to(x.dtype), states[:, -1], states, starts


def chunked_bwd(x, r_gate, i_gate, lam, h0, states, dout, dh_last=None):
    """(dx, dr, di in x's dtype, dlam (W,) f32, dh0 (B, W) f32): what
    ``rglru_bwd``'s kernels compute, phase by phase.  Used by the tests
    only."""
    B, S, W = x.shape
    g = _gates(x, r_gate, i_gate, lam)
    lamf = lam.float()
    base = -ref.RGLRU_C * ref.softplus(lamf)
    dbase = -ref.RGLRU_C * torch.sigmoid(lamf)
    h_init = x.new_zeros(B, 1, W, dtype=torch.float32) if h0 is None \
        else h0.float()[:, None]
    prev = torch.cat([h_init, states[:, :-1]], 1)                      # h_{t-1}
    a, d = _chunks(g["a"], 1.0), _chunks(dout.float(), 0.0)
    # padded steps: a = 1, dout = 0 keep the carry; sr = 0 keeps dlam; the
    # rest only has to stay finite (its outputs are cut off)
    xs, hp, sr, si, e2 = (_chunks(t, 0.0) for t in (x.float(), prev, g["sr"], g["si"],
                                                    g["e2"]))
    mult, floored = _chunks(g["mult"], 1.0), _chunks(g["floored"], True)
    V, A = torch.zeros_like(a[:, :, 0]), torch.ones_like(a[:, :, 0])   # 1.
    for s in range(CHUNK - 1, -1, -1):
        V = a[:, :, s] * (d[:, :, s] + V)
        A = A * a[:, :, s]
    nc = a.shape[1]                                                    # 2.
    y = x.new_zeros(B, W, dtype=torch.float32) if dh_last is None else dh_last.float()
    ends = [None] * nc
    ends[nc - 1] = y
    for c in range(nc - 1, 0, -1):
        y = A[:, c] * y + V[:, c]
        ends[c - 1] = y
    carry = torch.stack(ends, 1)                                       # 3.
    dlam = torch.zeros_like(carry)
    dx, dr, di = ([None] * CHUNK for _ in range(3))
    for s in range(CHUNK - 1, -1, -1):
        dh = d[:, :, s] + carry
        dgated = dh * mult[:, :, s]
        dlog_a = dh * hp[:, :, s] * a[:, :, s] - torch.where(
            floored[:, :, s], 0.0, dh * si[:, :, s] * xs[:, :, s] * e2[:, :, s] / mult[:, :, s])
        carry = a[:, :, s] * dh
        dx[s] = dgated * si[:, :, s]
        di[s] = dgated * xs[:, :, s] * si[:, :, s] * (1.0 - si[:, :, s])
        dr[s] = dlog_a * base * sr[:, :, s] * (1.0 - sr[:, :, s])
        dlam = dlam + dlog_a * sr[:, :, s] * dbase
    cast = (lambda t: _unchunk(torch.stack(t, 2), S).to(x.dtype))  # noqa: E731
    return cast(dx), cast(dr), cast(di), dlam.sum((0, 1)), carry[:, 0]


# ----------------------------------------------------------------------
# The kernels as operators (``torch.ops.repro_torch.rglru_*``): the CUDA
# implementation launches, the shape function allocates the same outputs
# and scratch
# ----------------------------------------------------------------------
def _scratch(B, S, W, like):
    """The kernels' (2, NC - 1, B, W) f32 buffer of chunk products and local
    values (empty for a single chunk).  The operators return it, so that a
    shape-only lowering counts it while the launch holds it."""
    nc = num_chunks(S)
    return like.new_empty((2, nc - 1, B, W) if nc > 1 else (0,), dtype=torch.float32)


def _fwd_outputs(x, save_states):
    """out, h_last (B, W) f32, the f32 states (B, S, W) (empty unless
    saved), and the scratch."""
    B, S, W = x.shape
    f32 = torch.float32
    return (torch.empty_like(x), x.new_empty((B, W), dtype=f32),
            x.new_empty((B, S, W) if save_states else (0,), dtype=f32), _scratch(B, S, W, x))


def _fwd_cuda(x, r_gate, i_gate, lam, h0, save_states):
    out, h_last, states, scratch = _fwd_outputs(x, save_states)
    B, S, W = x.shape
    err = load_library().rglru_fwd(
        x.data_ptr(), r_gate.data_ptr(), i_gate.data_ptr(), lam.data_ptr(), ptr(h0),
        out.data_ptr(), h_last.data_ptr(), ptr(states) if save_states else None,
        ptr(scratch) if scratch.numel() else None, B, S, W, DTYPE_CODE[x.dtype], stream())
    LAUNCHES["rglru_fwd"] += 1
    raise_on(err, "rglru_fwd")
    return out, h_last, states, scratch


def _bwd_outputs(x):
    """dx, dr, di, dlam's (NC, B, W) f32 partials, dh0 (B, W) f32, and the
    scratch."""
    B, S, W = x.shape
    f32 = torch.float32
    return (torch.empty_like(x), torch.empty_like(x), torch.empty_like(x),
            x.new_empty((num_chunks(S), B, W), dtype=f32), x.new_empty((B, W), dtype=f32),
            _scratch(B, S, W, x))


def _bwd_cuda(x, r_gate, i_gate, lam, h0, states, dout, dh_last):
    dx, dr, di, dlam_part, dh0, scratch = _bwd_outputs(x)
    B, S, W = x.shape
    err = load_library().rglru_bwd(
        x.data_ptr(), r_gate.data_ptr(), i_gate.data_ptr(), lam.data_ptr(), ptr(h0),
        states.data_ptr(), dout.data_ptr(), ptr(dh_last), dx.data_ptr(), dr.data_ptr(),
        di.data_ptr(), dlam_part.data_ptr(), dh0.data_ptr(),
        ptr(scratch) if scratch.numel() else None, B, S, W, DTYPE_CODE[x.dtype], stream())
    LAUNCHES["rglru_bwd"] += 1
    raise_on(err, "rglru_bwd")
    return dx, dr, di, dlam_part, dh0, scratch


def _flops(name):
    """The FLOP formula of kernel ``name`` (:func:`repro_torch.kernels.cost.
    rglru_flops`) over its arguments, tensors given as shapes."""
    def formula(x, *_, out_shape=None, **__):
        return int(cost.rglru_flops(*x)[name])
    return formula


_OPS = Operators(__name__)
_GATES = "Tensor x, Tensor r_gate, Tensor i_gate, Tensor lam, Tensor? h0"
_fwd_op = _OPS.define(f"rglru_fwd({_GATES}, bool save_states) "
                      "-> (Tensor, Tensor, Tensor, Tensor)", _fwd_cuda,
                      lambda x, *a: _fwd_outputs(x, a[-1]), _flops("rglru_fwd"))
_bwd_op = _OPS.define(f"rglru_bwd({_GATES}, Tensor states, Tensor dout, Tensor? dh_last) "
                      "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)", _bwd_cuda,
                      lambda x, *_: _bwd_outputs(x), _flops("rglru_bwd"))


# ----------------------------------------------------------------------
# Wrappers: one per kernel
# ----------------------------------------------------------------------
def fwd(x, r_gate, i_gate, lam, h0=None, save_states=False):
    """(out, h_last, states or None).  ``rglru_fwd`` on CUDA tensors (its
    shape function on meta ones), :func:`plain_fwd` on CPU tensors."""
    check_inputs(x, r_gate, i_gate, lam, h0)
    if not on_kernel_path(x):
        return plain_fwd(x, r_gate, i_gate, lam, h0, save_states)
    out, h_last, states, _ = _fwd_op(x, r_gate, i_gate, lam, h0, save_states)
    return out, h_last, (states if save_states else None)


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
    if not on_kernel_path(x):
        return plain_bwd(x, r_gate, i_gate, lam, h0, states, dout, dh_last)
    dx, dr, di, dlam_part, dh0, _ = _bwd_op(x, r_gate, i_gate, lam, h0, states, dout, dh_last)
    return dx, dr, di, dlam_part.sum((0, 1)), dh0


#: the CUDA kernels behind the two wrappers, as :func:`occupancy` names them
KERNELS = ("local_fwd", "local_bwd", "combine", "fwd_out", "bwd_chunk")


def occupancy(kernel: str) -> dict:
    """Resources of the bfloat16 instantiation of ``kernel`` (one of
    :data:`KERNELS`) that the main path runs (one lane a thread forward, two
    backward), as the CUDA runtime reports them: registers a thread, shared
    bytes, threads and CTAs per SM.  Launches nothing."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    out = (ctypes.c_int * 4)()
    raise_on(load_library().rglru_occupancy(KERNELS.index(kernel), out), "rglru_occupancy")
    return dict(zip(("registers", "smem_bytes", "threads", "ctas_per_sm"), out))


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
    f32); differentiable in every input.  Under ``torch.no_grad`` (decode)
    the forward saves no states."""
    if not torch.is_grad_enabled():
        out, h_last, _ = fwd(x.contiguous(), r_gate.contiguous(), i_gate.contiguous(), lam,
                             h0)
        return out, h_last
    return RGLRU.apply(x, r_gate, i_gate, lam, h0)
