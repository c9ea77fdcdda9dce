"""RWKV6 wkv scan for Hopper: forward and backward CUDA kernels, as a
chunk-parallel exact scan.

Replaces the TPU kernel ``src/repro/kernels/wkv6.py::_wkv6_kernel``
(Pallas, forward only).  The kernels live in ``repro_torch/csrc/wkv6.cu``,
built at first use with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface (:mod:`repro_torch.kernels.build`), loaded with ``ctypes``
and launched on PyTorch's current stream.

They compute the reference's step recurrence (:func:`repro_torch.kernels.
ref.wkv6`), exact at any decay, and not the Pallas kernel's chunked
log-decay form, which overflows float32 once a 64-token block's decay
passes e^-88 (a per-token w below ~0.25).  Only products of w are taken:
no log, exp or division, so w = 0 and w = 1 stay exact.

What bounds them on this card: the function needs ~5 float32 operations
per state entry and step forward (~14 backward) over B·H (hd, hd) states,
so the CUDA cores' float32 rate (~20 us forward at B 2, S 1024, H 32,
hd 64), but the step scan has only B·H dependent S-step chains.  The design
cuts time into chunks of :data:`CHECKPOINT` steps and runs three kernels per
wrapper call (the source's header has the detail):

1. per (b, h, chunk), in parallel: the chunk's local end state from zero
   (forward: U_c, the step recurrence; backward: V_c, the state cotangent
   walked back) and its decay product D_c = prod w;
2. per state entry, sequential over the chunks only: S_{c+1} = D_c S_c +
   U_c (forward, giving the checkpoints and the final state), G_end(c-1) =
   D_c G_end(c) + V_c (backward, from the final-state cotangent, giving
   ds0);
3. per (b, h, chunk), in parallel: the step recurrence from the chunk's
   start, writing o (forward); the chunk's states rebuilt from its
   checkpoint and walked back from G_end(c), writing dr, dk, dv, dw and a
   du partial per chunk (backward), each summed over the value columns
   inside the CTA and written once in r's dtype.

On an NVIDIA H100 80GB HBM3 at 700.00 W, rwkv6-1.6b's shape takes 0.119 ms
forward and 0.335 ms backward against bounds of 0.020 and 0.056 ms
(``chip_smoke.py``; ``PERF.md`` has the table).

:func:`chunked_fwd` and :func:`chunked_bwd` emulate the three phases in
PyTorch, vectorised over chunks; the CPU tests hold them to the JAX
reference.

Two wrappers, each with a launch counter in :data:`LAUNCHES` (one count
per call, for its three CUDA launches) and a plain PyTorch version beside
it:

==============  ==============  ============================================
wrapper         kernel          plain version
==============  ==============  ============================================
:func:`fwd`     ``wkv6_fwd``    :func:`plain_fwd` (the reference's f32 scan,
                                with the checkpoints)
:func:`bwd`     ``wkv6_bwd``    :func:`plain_bwd` (the chunked reverse-time
                                scan in torch, vectorised over (b, h))
==============  ==============  ============================================

Each wrapper's kernel is a PyTorch operator, ``torch.ops.repro_torch.
wkv6_fwd`` / ``wkv6_bwd`` (:class:`repro_torch.kernels.build.Operators`):
its CUDA implementation launches and counts; its shape function allocates
the same outputs and scratch (the checkpoints, ``gbuf``, ``dbuf``, du's
partials) and launches nothing; its FLOP formula is :func:`repro_torch.
kernels.cost.wkv6_flops`.  A wrapper given CPU tensors computes its plain
version; given CUDA tensors it launches its kernels or raises (no
fallback); given fake or meta tensors (a shape-only lowering) it runs the
shape function.  :func:`wkv6` is the differentiable entry point
(:class:`WKV6`).  No atomics: the results are
deterministic.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import cost, ref
from repro_torch.kernels.build import (DTYPE_CODE, Operators, check_aligned, check_f32,
                                       check_same, load, on_kernel_path, ptr, raise_on, stream)

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "wkv6.cu"
#: head dims the kernels are instantiated for
HEAD_DIMS = (32, 64)
#: steps per chunk, and between the forward's saved states
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
                "wkv6_fwd": [p] * 10 + [i] * 5 + [p],
                "wkv6_bwd": [p] * 16 + [i] * 5 + [p],
                "wkv6_occupancy": [i, i, p],
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
# The kernels' three phases in PyTorch (float32 math), vectorised over chunks
# ----------------------------------------------------------------------
def _chunks(t: torch.Tensor, fill: float) -> torch.Tensor:
    """(B, S, H, hd) -> (B, H, NC, CHECKPOINT, hd) float32, the ragged last
    chunk padded with ``fill``: padded steps with w = 1 and k, v, r, dout =
    0 leave every state and cotangent exactly as it is."""
    B, S, H, hd = t.shape
    nc = num_checkpoints(S)
    t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, nc * CHECKPOINT - S), value=fill)
    return t.reshape(B, nc, CHECKPOINT, H, hd).permute(0, 3, 1, 2, 4)


def _unchunk(t: torch.Tensor, S: int) -> torch.Tensor:
    """(B, H, NC, CHECKPOINT, hd) -> (B, S, H, hd)."""
    B, H, nc, C, hd = t.shape
    return t.permute(0, 2, 3, 1, 4).reshape(B, nc * C, H, hd)[:, :S]


def _local(a, b, w, reverse: bool):
    """Phase 1: X <- diag(w_t) X + a_t b_t^T over each chunk's steps from X =
    0 (in reverse time when ``reverse``), and D = prod_t w_t; a, b, w as
    :func:`_chunks` gives them.  (X (B, H, NC, hd, hd), D (B, H, NC, hd))."""
    B, H, nc, C, hd = a.shape
    x = a.new_zeros(B, H, nc, hd, hd)
    d = a.new_ones(B, H, nc, hd)
    for s in (range(C - 1, -1, -1) if reverse else range(C)):
        x = w[..., s, :, None] * x + a[..., s, :, None] * b[..., s, None, :]
        d = d * w[..., s, :]
    return x, d


def _combine(x, d, init, reverse: bool):
    """Phase 2: over the chunks in order (in reverse when ``reverse``), the
    value before each chunk, carried by y <- D_c y + X_c from ``init`` (or
    0).  (the values before each chunk (B, H, NC, hd, hd), the last y)."""
    y = torch.zeros_like(x[:, :, 0]) if init is None else init.float()
    before = [None] * x.shape[2]
    for c in (range(x.shape[2] - 1, -1, -1) if reverse else range(x.shape[2])):
        before[c] = y
        y = d[:, :, c, :, None] * y + x[:, :, c]
    return torch.stack(before, 2), y


def chunked_fwd(r, k, v, w, u, state=None):
    """(out in r's dtype, s_last, the checkpoints (B, H, NC, hd, hd)): what
    ``wkv6_fwd``'s three kernels compute, phase by phase.  Used by the
    tests only."""
    S = r.shape[1]
    rs, ks, vs, ws = _chunks(r, 0.0), _chunks(k, 0.0), _chunks(v, 0.0), _chunks(w, 1.0)
    U, D = _local(ks, vs, ws, reverse=False)                       # 1.
    ckpt, s_last = _combine(U, D, state, reverse=False)            # 2.
    ruk = (rs * u.float()[None, :, None, None, :] * ks).sum(-1)    # 3.
    st, outs = ckpt, []
    for s in range(CHECKPOINT):
        outs.append(torch.einsum("bhni,bhnij->bhnj", rs[..., s, :], st)
                    + ruk[..., s, None] * vs[..., s, :])
        st = ws[..., s, :, None] * st + ks[..., s, :, None] * vs[..., s, None, :]
    return _unchunk(torch.stack(outs, 3), S).to(r.dtype), s_last, ckpt


def chunked_bwd(r, k, v, w, u, ckpt, dout, ds_last=None):
    """(dr, dk, dv, dw in r's dtype, du (H, hd), ds0): what ``wkv6_bwd``'s
    three kernels compute, phase by phase.  Used by the tests only."""
    S = r.shape[1]
    rs, ks, vs, ws, ds = (_chunks(t, f) for t, f in ((r, 0.0), (k, 0.0), (v, 0.0), (w, 1.0),
                                                       (dout, 0.0)))
    uf = u.float()[None, :, None, :]
    V, D = _local(rs, ds, ws, reverse=True)                        # 1.
    g, ds0 = _combine(V, D, ds_last, reverse=True)                 # 2.: G_end(c)
    prev, st = [], ckpt                                            # 3.
    for s in range(CHECKPOINT):
        prev.append(st)
        st = ws[..., s, :, None] * st + ks[..., s, :, None] * vs[..., s, None, :]
    vdo = (vs * ds).sum(-1, keepdim=True)
    ruk = (rs * uf[..., None, :] * ks).sum(-1, keepdim=True)
    dr, dk, dv, dw = ([None] * CHECKPOINT for _ in range(4))
    for s in range(CHECKPOINT - 1, -1, -1):
        rt, kt, vt, wt, dt = (t[..., s, :] for t in (rs, ks, vs, ws, ds))
        dr[s] = torch.einsum("bhnij,bhnj->bhni", prev[s], dt) + uf * kt * vdo[..., s, :]
        dk[s] = torch.einsum("bhnij,bhnj->bhni", g, vt) + uf * rt * vdo[..., s, :]
        dv[s] = torch.einsum("bhnij,bhni->bhnj", g, kt) + ruk[..., s, :] * dt
        dw[s] = (g * prev[s]).sum(-1)
        g = wt[..., None] * g + rt[..., None] * dt[..., None, :]
    du = (rs * ks * vdo).sum((0, 2, 3))
    cast = (lambda t: _unchunk(torch.stack(t, 3), S).to(r.dtype))  # noqa: E731
    return cast(dr), cast(dk), cast(dv), cast(dw), du, ds0


# ----------------------------------------------------------------------
# The kernels as operators (``torch.ops.repro_torch.wkv6_*``): the CUDA
# implementation launches, the shape function allocates the same outputs
# and scratch
# ----------------------------------------------------------------------
def _fwd_outputs(r):
    """out, s_last (B, H, hd, hd) f32, the checkpoints (B, H, NC, hd, hd)
    f32 (always written), and the scratch dbuf (B, H, NC, hd) f32.  The
    operators return their scratch, so that a shape-only lowering counts it
    while the launch holds it."""
    B, S, H, hd = r.shape
    nc, f32 = num_checkpoints(S), torch.float32
    return (torch.empty_like(r), r.new_empty((B, H, hd, hd), dtype=f32),
            r.new_empty((B, H, nc, hd, hd), dtype=f32), r.new_empty((B, H, nc, hd), dtype=f32))


def _fwd_cuda(r, k, v, w, u, state):
    out, s_last, ckpt, dbuf = _fwd_outputs(r)
    B, S, H, hd = r.shape
    err = load_library().wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), ptr(state),
        out.data_ptr(), s_last.data_ptr(), ckpt.data_ptr(), dbuf.data_ptr(), B, S, H, hd,
        DTYPE_CODE[r.dtype], stream())
    LAUNCHES["wkv6_fwd"] += 1
    raise_on(err, "wkv6_fwd")
    return out, s_last, ckpt, dbuf


def _bwd_outputs(r):
    """dr, dk, dv, dw, du's (B, NC, H, hd) f32 partials, ds0 (B, H, hd, hd)
    f32, and the scratch gbuf (B, H, NC, hd, hd) and dbuf (B, H, NC, hd)
    f32."""
    B, S, H, hd = r.shape
    nc, f32 = num_checkpoints(S), torch.float32
    return (*(torch.empty_like(r) for _ in range(4)), r.new_empty((B, nc, H, hd), dtype=f32),
            r.new_empty((B, H, hd, hd), dtype=f32), r.new_empty((B, H, nc, hd, hd), dtype=f32),
            r.new_empty((B, H, nc, hd), dtype=f32))


def _bwd_cuda(r, k, v, w, u, ckpt, dout, ds_last):
    check_aligned("ckpt", ckpt)
    dr, dk, dv, dw, du_part, ds0, gbuf, dbuf = _bwd_outputs(r)
    B, S, H, hd = r.shape
    err = load_library().wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), ckpt.data_ptr(),
        dout.data_ptr(), ptr(ds_last), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dw.data_ptr(), du_part.data_ptr(), ds0.data_ptr(), gbuf.data_ptr(), dbuf.data_ptr(),
        B, S, H, hd, DTYPE_CODE[r.dtype], stream())
    LAUNCHES["wkv6_bwd"] += 1
    raise_on(err, "wkv6_bwd")
    return dr, dk, dv, dw, du_part, ds0, gbuf, dbuf


def _flops(name):
    """The FLOP formula of kernel ``name`` (:func:`repro_torch.kernels.cost.
    wkv6_flops`) over its arguments, tensors given as shapes."""
    def formula(r, *_, out_shape=None, **__):
        return int(cost.wkv6_flops(*r)[name])
    return formula


_OPS = Operators(__name__)
_RKVWU = "Tensor r, Tensor k, Tensor v, Tensor w, Tensor u"
_fwd_op = _OPS.define(f"wkv6_fwd({_RKVWU}, Tensor? state) -> (Tensor, Tensor, Tensor, Tensor)",
                      _fwd_cuda, lambda r, *_: _fwd_outputs(r), _flops("wkv6_fwd"))
_bwd_op = _OPS.define(f"wkv6_bwd({_RKVWU}, Tensor ckpt, Tensor dout, Tensor? ds_last) "
                      "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
                      _bwd_cuda, lambda r, *_: _bwd_outputs(r), _flops("wkv6_bwd"))


# ----------------------------------------------------------------------
# Wrappers: one per kernel
# ----------------------------------------------------------------------
def fwd(r, k, v, w, u, state=None, save_ckpt=False):
    """(out, s_last, checkpoints or None).  ``wkv6_fwd`` on CUDA tensors (its
    shape function on meta ones), :func:`plain_fwd` on CPU tensors.  The
    kernels always write the checkpoints (the chunk-start states their last
    phase starts from)."""
    check_inputs(r, k, v, w, u, state)
    if not on_kernel_path(r):
        return plain_fwd(r, k, v, w, u, state, save_ckpt)
    out, s_last, ckpt, _ = _fwd_op(r, k, v, w, u, state)
    return out, s_last, ckpt if save_ckpt else None


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
    nc = num_checkpoints(S)
    check_f32("ckpt", ckpt, (B, H, nc, hd, hd), r.device)
    check_f32("ds_last", ds_last, (B, H, hd, hd), r.device)
    if not on_kernel_path(r):
        return plain_bwd(r, k, v, w, u, ckpt, dout, ds_last)
    dr, dk, dv, dw, du_part, ds0, *_ = _bwd_op(r, k, v, w, u, ckpt, dout, ds_last)
    return dr, dk, dv, dw, du_part.sum((0, 1)), ds0


#: the CUDA kernels behind the two wrappers, as :func:`occupancy` names them
KERNELS = ("local_fwd", "local_bwd", "combine", "fwd_out", "bwd_chunk")


def occupancy(kernel: str, hd: int) -> dict:
    """Resources of the bfloat16 instantiation of ``kernel`` (one of
    :data:`KERNELS`) at head dim ``hd``, as the CUDA runtime reports them:
    registers a thread, shared bytes, threads and CTAs per SM.  Launches
    nothing."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    out = (ctypes.c_int * 4)()
    raise_on(load_library().wkv6_occupancy(KERNELS.index(kernel), hd, out), "wkv6_occupancy")
    return dict(zip(("registers", "smem_bytes", "threads", "ctas_per_sm"), out))


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
    dtype, final state (B, H, hd, hd) f32); differentiable in every input.
    Under ``torch.no_grad`` (decode) the checkpoints are not kept."""
    if not torch.is_grad_enabled():
        out, s_last, _ = fwd(*(t.contiguous() for t in (r, k, v, w)), u, state)
        return out, s_last
    return WKV6.apply(r, k, v, w, u, state)
