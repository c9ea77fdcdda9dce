"""GQA attention: parameters, projections with QKV bias, RoPE, the
full-sequence forward (self-attention, or cross-attention from ``kv_src``),
and the KV-cache decode.

Counterpart of :mod:`repro.models.attention` lines 24-148.  The inner
attention math is :func:`repro_torch.kernels.ops.attention` (the Hopper
kernels on CUDA, the plain oracle on the CPU) and, in decode,
:func:`repro_torch.kernels.ops.decode_attention` (plain torch everywhere,
as in the reference).  The sequence-sharded decode
(``_decode_attention_seq_sharded``) needs a mesh and is not ported:
``seq_axis`` raises.
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


def _project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, kv_src: torch.Tensor):
    """q from ``x``; k and v from ``kv_src`` (``x`` itself in self-attention)."""
    q, k, v = _proj(x, p["wq"]), _proj(kv_src, p["wk"]), _proj(kv_src, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def attention_fwd(cfg: ModelConfig, p: Params, x: torch.Tensor, *, causal: bool = True,
                  window: int | None = None, kv_src: torch.Tensor | None = None,
                  use_rope: bool = True) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  Self-attention at positions ``arange(S)``,
    rotated unless ``use_rope`` is False (the encoder's bidirectional
    attention passes ``causal=False`` and keeps RoPE, as the reference
    does); or, given ``kv_src`` (B, S_kv, d), cross-attention: k and v
    projected from ``kv_src``, no RoPE and no causal mask (reference
    ``attention_fwd``: ``causal and not cross``)."""
    B, S, _ = x.shape
    cross = kv_src is not None
    q, k, v = _project_qkv(cfg, p, x, kv_src if cross else x)
    if use_rope and not cross:
        pos = torch.arange(S, device=x.device).expand(B, S)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = kops.attention(q, k, v, causal=causal and not cross, window=window)
    H, hd, d = p["wo"].shape
    return out.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, d)


# ----------------------------------------------------------------------
# KV-cache decode (serve_step): one token against a seq_len cache
# ----------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int, window: int | None = None,
                  device="cpu", lead: tuple[int, ...] = ()) -> Params:
    """Zero ``k`` and ``v`` (*lead, B, S, K, hd) in ``cfg.dtype``: S is
    ``seq_len``, or ``min(seq_len, window)`` slots of a ring buffer for a
    windowed block."""
    S = min(seq_len, window) if window else seq_len
    shape = (*lead, batch, S, cfg.kv_heads, cfg.head_size)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def decode_attention(cfg: ModelConfig, p: Params, x: torch.Tensor, cache: Params, pos: int,
                     *, window: int | None = None,
                     seq_axis: str | None = None) -> tuple[torch.Tensor, Params]:
    """One decode step: x (B, 1, d) at position ``pos`` (a Python int, so
    that the slot and the mask are computed on the host) -> ((B, 1, d),
    cache).  The new token's k and v, rotated first, are written into the
    cache in place, at ``pos`` or, in a ring buffer (``window``), at ``pos
    % cache_len``; the returned cache is the one passed in.  Its contents
    equal the reference's one-hot write slot for slot."""
    if seq_axis is not None:
        raise NotImplementedError("the sequence-sharded decode needs a mesh "
                                  "(ROADMAP.md queue 1, item 1.4)")
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(cfg, p, x, x)
    posb = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)
    cache_len = cache["k"].shape[-3]
    if window:
        # the ring buffer holds the last cache_len tokens; once it has
        # wrapped, every slot is valid
        slot = pos % cache_len
        last = cache_len - 1 if pos >= cache_len else slot
    else:
        if not 0 <= pos < cache_len:
            raise ValueError(f"position {pos} outside the cache of {cache_len}")
        slot = last = pos
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    valid = torch.arange(cache_len, device=x.device) <= last
    out = kops.decode_attention(q, cache["k"], cache["v"], valid)
    H, hd, d = p["wo"].shape
    return out.reshape(B, 1, H * hd) @ p["wo"].reshape(H * hd, d), cache
