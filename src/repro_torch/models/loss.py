"""Vocab-chunked softmax cross-entropy as an ``autograd.Function``.

Counterpart of :mod:`repro.models.loss`: the loss is a running
logsumexp and label-logit gather over vocab chunks, and the backward
recomputes each chunk's logits, so no (B, S, V) logits live at once.
Same chunk rule (:func:`_num_chunks`); qwen1.5-4b's 151 936 vocabulary
splits into 32 chunks of 4748.
"""
from __future__ import annotations

import torch

DEFAULT_CHUNK = 8192


def _num_chunks(V: int, chunk: int) -> int:
    if V % chunk:
        # fall back to the largest divisor <= chunk
        for c in range(chunk, 0, -1):
            if V % c == 0:
                return V // c
    return V // chunk


def _lse_scan(x, head, labels, nc):
    """(logsumexp, label logit), each (B, S) f32, over ``nc`` chunks."""
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
    return m + torch.log(l.clamp_min(1e-30)), lab


class ChunkedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, head, labels, chunk):
        nc = _num_chunks(head.shape[1], min(chunk, head.shape[1]))
        lse, lab = _lse_scan(x, head, labels, nc)
        ctx.save_for_backward(x, head, labels, lse)
        ctx.nc = nc
        return (lse - lab).mean()

    @staticmethod
    def backward(ctx, dloss):
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
        return dx.to(x.dtype), dhead, None, None


def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                          chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Mean token NLL.  x: (B, S, d); head: (d, V); labels: (B, S) int."""
    return ChunkedCrossEntropy.apply(x, head, labels, chunk)
