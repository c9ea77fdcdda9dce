"""Vocab-chunked softmax cross-entropy as an ``autograd.Function``.

Counterpart of :mod:`repro.models.loss`: the loss is a running
logsumexp and label-logit gather over vocab chunks, and the backward
recomputes each chunk's logits, so no (B, S, V) logits live at once.
Same chunk rule (:func:`_num_chunks`); qwen1.5-4b's 151 936 vocabulary
splits into 32 chunks of 4748.

**A vocabulary split over ``model``** (``tp``, :mod:`repro_torch.comm.
tensor_parallel`; the reference's logits are ``constrain``-ed to
``("batch", None, "tensor")``): each rank holds the logits of its block of
the vocabulary (the chunks are of that block), and the loss takes two
all-reduces over ``model``: the max of each row's logits, then the sums
of the rows' shifted exponentials and of the target logits (each target
lies in one rank's block; the others add 0).  The backward needs none:
each rank's block of ``softmax - onehot`` is its own.
:func:`vocab_parallel_cross_entropy` is the plain (unchunked) path's.

**The backward's products on the tensor cores.**  Each chunk's backward
runs two products with the f32 ``dlogits``: ``dlogits @ head_c.T`` into
x's f32 cotangent and ``x.T @ dlogits`` for the head's.  Where x and the
head are both bfloat16 (:func:`takes_split`), ``dlogits`` is split into
three bfloat16 terms whose sum is it exactly (:func:`split3`), and each
product is three bfloat16 products accumulated in f32
(:func:`split_products`): a product of two bfloat16 numbers is exact in
f32.  On CUDA (and on the meta device, so that a dry run counts what the
card runs) they are tensor-core products with an f32 output; the CPU has
none, and multiplies the same operands in f32, where their products are as
exact and their sums round to nearest.  The tensor cores' f32 accumulator
does not round to nearest: its error grows with the length of the inner
dimension it sums, so the leading term sums :data:`ACC_BLOCK` of it at a
time and adds the blocks in f32 (the lower terms are 2^-8 and 2^-16 of it,
and run whole).  So the result keeps the f32 product's precision, as the
reference's (``repro.models.loss`` multiplies in f32).  Every other case
(f32; fp16, whose exponent range cannot hold the lower terms) runs the f32
products.

Under :func:`repro_torch.tracing.record` both functions' forward and
backward are the spans ``fwd.loss`` and ``bwd.loss``; the backward keeps
the recorder of its forward, as it may run on the autograd engine's device
thread.  The counter ``loss.split_chunks`` adds 1 for each chunk whose
products ran through the split.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch import tracing
from repro_torch.comm.tensor_parallel import TensorParallel, max_over_model, reduce_from_model

DEFAULT_CHUNK = 8192
#: the inner-dimension block of the leading term's tensor-core products
#: (module docstring)
ACC_BLOCK = 1024


def _num_chunks(V: int, chunk: int) -> int:
    if V % chunk:
        # fall back to the largest divisor <= chunk
        for c in range(chunk, 0, -1):
            if V % c == 0:
                return V // c
    return V // chunk


def takes_split(x: torch.Tensor, head: torch.Tensor) -> bool:
    """Whether the backward's products run through the split (module
    docstring): x and head bfloat16, on any device."""
    return x.dtype == head.dtype == torch.bfloat16


def split3(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hi, mid, lo) in bfloat16 with ``hi + mid + lo == d`` exactly for f32
    ``d`` (f32 subnormals aside): each term rounds to nearest what the terms
    before it leave, a residual that f32 holds exactly."""
    hi = d.to(torch.bfloat16)
    r = d - hi
    mid = r.to(torch.bfloat16)
    r -= mid
    return hi, mid, r.to(torch.bfloat16)


def _mm_f32(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor | None = None):
    """``a @ b`` of bfloat16 operands accumulated and returned in f32, added
    into ``acc`` where given: a tensor-core product with an f32 output, or on
    the CPU the f32 product of the operands (module docstring)."""
    if a.device.type == "cpu":
        a, b = a.float(), b.float()
        return a @ b if acc is None else acc.addmm_(a, b)
    if acc is None:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.addmm(acc, a, b, out_dtype=torch.float32, out=acc)


def _blocked(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor | None):
    """``acc + a @ b`` (``a @ b`` where ``acc`` is None) with the inner
    dimension taken in blocks of :data:`ACC_BLOCK`: each block's sum is
    added to the f32 result rounding to nearest.  Tensors without data
    (fake or meta: a shape-only lowering) take the product whole, which
    counts the same FLOPs and bytes in one dispatch instead of one a
    block."""
    if a.is_meta or isinstance(a, FakeTensor):
        return _mm_f32(a, b, acc)
    for k in range(0, a.shape[1], ACC_BLOCK):
        acc = _mm_f32(a[:, k:k + ACC_BLOCK], b[k:k + ACC_BLOCK], acc)
    return acc


def split_products(dlogits: torch.Tensor, x: torch.Tensor, hc: torch.Tensor,
                   dx: torch.Tensor) -> torch.Tensor:
    """One chunk's two products through :func:`split3` of ``dlogits`` (N, c)
    f32: adds ``dlogits @ hc.T`` into ``dx`` (N, d) f32 and returns ``x.T @
    dlogits`` (d, c) in f32, for bfloat16 x (N, d) and hc (d, c).  The
    leading term's products run in blocks of :data:`ACC_BLOCK` along the
    inner dimension (module docstring); the two lower terms' whole."""
    hi, mid, lo = split3(dlogits)
    _blocked(hi, hc.T, dx)
    dhc = _blocked(x.T, hi, None)
    for t in (mid, lo):
        _mm_f32(t, hc.T, dx)
        _mm_f32(x.T, t, dhc)
    return dhc


def _lse_scan(x, head, labels, nc):
    """(running max, sum of exponentials shifted by it, label logit), each
    (B, S) f32, over ``nc`` chunks; a label outside ``head``'s columns
    gives 0."""
    B, S, _ = x.shape
    c = head.shape[1] // nc
    m = torch.full((B, S), -1e30, dtype=torch.float32, device=x.device)
    l = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    lab = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    for ic in range(nc):
        logits = (x @ head[:, ic * c:(ic + 1) * c]).float()
        m_new = torch.maximum(m, logits.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(dim=-1)
        m = m_new
        loc = labels - ic * c
        inside = (loc >= 0) & (loc < c)
        picked = torch.gather(logits, -1, loc.clamp(0, c - 1)[..., None])[..., 0]
        lab = torch.where(inside, picked, lab)
    return m, l, lab


def _combine(m, l, lab, tp: TensorParallel | None):
    """(logsumexp, label logit) of the whole vocabulary from each rank's
    (max, shifted sum, label logit) of its block."""
    if tp is not None:
        m_all = max_over_model(tp, m)
        l, lab = reduce_from_model(tp, torch.stack([l * torch.exp(m - m_all), lab]))
        m = m_all
    return m + torch.log(l.clamp_min(1e-30)), lab


class ChunkedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, head, labels, chunk, tp):
        ctx.rec = tracing.current()
        with tracing.span_on(ctx.rec, "fwd.loss"):
            nc = _num_chunks(head.shape[1], min(chunk, head.shape[1]))
            if tp is not None:      # this rank's block of the vocabulary
                labels = labels - tp.block(head.shape[1] * tp.size)[0]
            lse, lab = _combine(*_lse_scan(x, head, labels, nc), tp)
            ctx.save_for_backward(x, head, labels, lse)
            ctx.nc = nc
            return (lse - lab).mean()

    @staticmethod
    def backward(ctx, dloss):
        with tracing.span_on(ctx.rec, "bwd.loss"):
            return ChunkedCrossEntropy._backward(ctx, dloss)

    @staticmethod
    def _backward(ctx, dloss):
        x, head, labels, lse = ctx.saved_tensors
        B, S, d = x.shape
        c = head.shape[1] // ctx.nc
        scale = dloss / (B * S)
        split = takes_split(x, head)
        xf = None if split else x.float()
        dx = torch.zeros((B, S, d), dtype=torch.float32, device=x.device)
        dhead = torch.empty_like(head)
        ar = torch.arange(c, device=x.device)
        for ic in range(ctx.nc):
            hc = head[:, ic * c:(ic + 1) * c]
            logits = (x @ hc).float()
            p = torch.exp(logits - lse[..., None])
            loc = labels - ic * c
            onehot = (ar == loc[..., None]) & ((loc >= 0) & (loc < c))[..., None]
            dlogits = (p - onehot.float()) * scale
            if split:
                del logits, p
                dhc = split_products(dlogits.reshape(B * S, c), x.reshape(B * S, d), hc,
                                     dx.view(B * S, d))
                if ctx.rec is not None:
                    ctx.rec.count("loss.split_chunks", 1)
            else:
                dx += dlogits @ hc.float().T
                dhc = xf.reshape(B * S, d).T @ dlogits.reshape(B * S, c)
            dhead[:, ic * c:(ic + 1) * c] = dhc.to(head.dtype)
        return dx.to(x.dtype), dhead, None, None, None


def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                          chunk: int = DEFAULT_CHUNK,
                          tp: TensorParallel | None = None) -> torch.Tensor:
    """Mean token NLL.  x: (B, S, d); head: (d, V), or this rank's (d, V /
    m) block of a vocabulary split over ``tp``'s ranks; labels: (B, S) int.
    x's cotangent is this rank's part (the caller sums it over ``model``)."""
    return ChunkedCrossEntropy.apply(x, head, labels, chunk, tp)


class VocabParallelCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, tp):
        ctx.rec = tracing.current()
        with tracing.span_on(ctx.rec, "fwd.loss"):
            V = logits.shape[-1]
            labels = labels - tp.block(V * tp.size)[0]
            m = logits.amax(dim=-1)
            inside = (labels >= 0) & (labels < V)
            picked = torch.gather(logits, -1, labels.clamp(0, V - 1)[..., None])[..., 0]
            l = torch.exp(logits - m[..., None]).sum(dim=-1)
            lse, lab = _combine(m, l, torch.where(inside, picked, torch.zeros_like(picked)),
                                tp)
            ctx.save_for_backward(logits, labels, lse)
            return (lse - lab).mean()

    @staticmethod
    def backward(ctx, dloss):
        with tracing.span_on(ctx.rec, "bwd.loss"):
            logits, labels, lse = ctx.saved_tensors
            V = logits.shape[-1]
            p = torch.exp(logits - lse[..., None])
            onehot = torch.arange(V, device=logits.device) == labels[..., None]
            return (p - onehot.to(p.dtype)) * (dloss / labels.numel()), None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 tp: TensorParallel) -> torch.Tensor:
    """Mean token NLL from this rank's block (B, S, V / m) of the float32
    logits (module docstring)."""
    return VocabParallelCrossEntropy.apply(logits, labels, tp)
