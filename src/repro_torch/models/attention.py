"""GQA self-attention: parameters, projections with QKV bias, RoPE, and the
full-sequence forward.

Counterpart of :mod:`repro.models.attention` lines 24-80.  The decode half
(KV caches, distributed flash-decode) waits for the serving slice.  The
inner attention math is :func:`repro_torch.kernels.ops.attention`: the
Hopper kernels on CUDA, the plain oracle on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.common import ModelConfig, Params, apply_rope, dense_init


def init_attention(cfg: ModelConfig, gen: torch.Generator, device,
                   lead: tuple[int, ...] = ()) -> Params:
    """``lead`` prepends axes (the stacked unit axis) to every leaf."""
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.head_size
    p: Params = {
        "wq": dense_init(gen, (*lead, d, H, hd), cfg.dtype, device, in_axis_size=d),
        "wk": dense_init(gen, (*lead, d, K, hd), cfg.dtype, device, in_axis_size=d),
        "wv": dense_init(gen, (*lead, d, K, hd), cfg.dtype, device, in_axis_size=d),
        "wo": dense_init(gen, (*lead, H, hd, d), cfg.dtype, device, in_axis_size=H * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, H, hd), dtype=cfg.dtype, device=device)
        p["bk"] = torch.zeros((*lead, K, hd), dtype=cfg.dtype, device=device)
        p["bv"] = torch.zeros((*lead, K, hd), dtype=cfg.dtype, device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def _project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def attention_fwd(cfg: ModelConfig, p: Params, x: torch.Tensor, *, causal: bool = True,
                  window: int | None = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), self-attention at positions ``arange(S)``."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    pos = torch.arange(S, device=x.device).expand(B, S)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    out = kops.attention(q, k, v, causal=causal, window=window)
    H, hd, d = p["wo"].shape
    return out.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, d)
