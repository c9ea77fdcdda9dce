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

Under :func:`repro_torch.tracing.record` both functions' forward and
backward are the spans ``fwd.loss`` and ``bwd.loss``; the backward keeps
the recorder of its forward, as it may run on the autograd engine's device
thread.
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.comm.tensor_parallel import TensorParallel, max_over_model, reduce_from_model

DEFAULT_CHUNK = 8192


def _num_chunks(V: int, chunk: int) -> int:
    if V % chunk:
        # fall back to the largest divisor <= chunk
        for c in range(chunk, 0, -1):
            if V % c == 0:
                return V // c
    return V // chunk


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
        xf = x.float()
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
            dx += dlogits @ hc.float().T
            dhead[:, ic * c:(ic + 1) * c] = \
                (xf.reshape(B * S, d).T @ dlogits.reshape(B * S, c)).to(head.dtype)
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
