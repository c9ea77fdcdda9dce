"""Plain PyTorch oracle for the attention kernel.

Counterpart of :func:`repro.kernels.ref.repeat_kv` and
:func:`repro.kernels.ref.attention`: the default implementation on the
CPU, and the plain version the kernels in
:mod:`repro_torch.kernels.flash_attention` are held against on the card.
Its backward is autograd's.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S, K, hd) -> (B, S, K*n, hd); query head h reads kv head h // n."""
    if n == 1:
        return k
    B, S, K, hd = k.shape
    return k[:, :, :, None, :].expand(B, S, K, n, hd).reshape(B, S, K * n, hd)


def attention(q, k, v, *, q_positions=None, kv_positions=None,
              causal=True, window=None):
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd) with H % K == 0."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    k = repeat_kv(k, H // K)
    v = repeat_kv(v, H // K)
    if q_positions is None:
        q_positions = torch.arange(Sq, device=q.device).expand(B, Sq)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=q.device).expand(B, Skv)
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) / math.sqrt(hd)
    qp = q_positions[:, None, :, None]
    kp = kv_positions[:, None, None, :]
    mask = torch.ones_like(scores, dtype=torch.bool)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs, v.float())
    return out.to(q.dtype)
