"""Plain PyTorch oracles for the kernels.

Counterpart of :func:`repro.kernels.ref.repeat_kv`,
:func:`repro.kernels.ref.attention`, :func:`repro.kernels.ref.rglru` and
:func:`repro.kernels.ref.wkv6`: the default implementation on the CPU, and
the plain versions the kernels in :mod:`repro_torch.kernels.flash_attention`,
:mod:`repro_torch.kernels.rglru` and :mod:`repro_torch.kernels.wkv6` are
held against on the card.  Their backward is autograd's.  The two decode
functions (:func:`decode_attention`, :func:`decode_attention_partials`)
have no kernel in either package: they are the implementation on every
device.
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


# ----------------------------------------------------------------------
# Decode attention: one query token against a cache, with a validity mask.
# ----------------------------------------------------------------------
def decode_attention(q, k, v, valid):
    """q: (B, 1, H, hd); k, v: (B, S, K, hd); valid: (S,) bool.  Returns
    (B, 1, H, hd) in q's dtype."""
    o, m, l = decode_attention_partials(q, k, v, valid)
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def decode_attention_partials(q, k, v, valid):
    """Unnormalised flash partials (o (B, 1, H, hd), m (B, 1, H), l (B, 1,
    H)), all f32, for combining across cache shards.  Grouped: query head h
    reads kv head h // (H // K), and the cache is never broadcast to H
    heads."""
    B, _, H, hd = q.shape
    K = k.shape[2]
    qh = q.reshape(B, K, H // K, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qh.float(), k.float()) / math.sqrt(hd)
    mask = valid[None, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)                                   # (B, K, G)
    p = torch.exp(scores - m[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)                                         # (B, K, G)
    o = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    return o.reshape(B, 1, H, hd), m.reshape(B, 1, H), l.reshape(B, 1, H)


# ----------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin):
#   a_t = exp(-c * softplus(Lambda) * sigmoid(r_t))
#   h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (sigmoid(i_t) * x_t)
# x, r_gate, i_gate: (B, S, W); lam: (W,); h: (B, W).
# ----------------------------------------------------------------------
RGLRU_C = 8.0


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` (``logaddexp(x, 0)``), with no
    threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def rglru_states(x, r_gate, i_gate, lam, h0=None):
    """(every state h_t as (B, S, W) f32, the last state (B, W) f32): the
    reference's f32 scan over time."""
    B, S, W = x.shape
    h = torch.zeros(B, W, dtype=torch.float32, device=x.device) if h0 is None \
        else h0.float()
    log_a_base = -RGLRU_C * softplus(lam.float())
    xs, rs, gs = (t.float() for t in (x, r_gate, i_gate))
    states = []
    for t in range(S):
        log_a = log_a_base * torch.sigmoid(rs[:, t])
        a = torch.exp(log_a)
        gated = torch.sigmoid(gs[:, t]) * xs[:, t]
        mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
        h = a * h + mult * gated
        states.append(h)
    return torch.stack(states, dim=1), h


def rglru(x, r_gate, i_gate, lam, h0=None):
    """(out (B, S, W) in x's dtype, h_final (B, W) f32)."""
    states, h = rglru_states(x, r_gate, i_gate, lam, h0)
    return states.to(x.dtype), h


# ----------------------------------------------------------------------
# RWKV6 "wkv" linear-attention scan with data-dependent decay (Finch).
#   S_t = diag(w_t) S_{t-1} + k_t v_t^T
#   o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
# r, k, v, w: (B, S, H, hd); u: (H, hd); per-head state S: (B, H, hd, hd)
# (row i = key channel, column j = value channel).
# ----------------------------------------------------------------------
def wkv6_checkpointed(r, k, v, w, u, state=None, every: int = 0):
    """(out (B, S, H, hd) in r's dtype, final state (B, H, hd, hd) f32, and
    when ``every`` > 0 the states before steps 0, every, 2 * every, ...
    stacked as (B, H, ceil(S / every), hd, hd) f32, else None): the
    reference's f32 step scan, exact at any decay."""
    B, S, H, hd = r.shape
    st = torch.zeros(B, H, hd, hd, dtype=torch.float32, device=r.device) \
        if state is None else state.float()
    rs, ks, vs, ws = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    outs, ckpt = [], []
    for t in range(S):
        if every and t % every == 0:
            ckpt.append(st)
        kv = ks[:, t, :, :, None] * vs[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rs[:, t], st + uf * kv))
        st = ws[:, t, :, :, None] * st + kv
    return (torch.stack(outs, dim=1).to(r.dtype), st,
            torch.stack(ckpt, dim=2) if every else None)


def wkv6(r, k, v, w, u, state=None):
    """(out (B, S, H, hd) in r's dtype, final state (B, H, hd, hd) f32)."""
    out, st, _ = wkv6_checkpointed(r, k, v, w, u, state)
    return out, st
