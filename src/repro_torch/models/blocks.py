"""Block registry for the ported kinds: ``G`` (global attention + MLP),
``L`` (sliding-window attention + MLP), ``R`` (RG-LRU recurrent block +
MLP), pre-norm residual, with the dense (gated SiLU or GELU) MLP; and ``W``
(RWKV6 time mix + channel mix, pre-norm residual, no MLP).

Counterpart of :mod:`repro.models.blocks` lines 28-122.  The ``C`` kind and
MoE raise ``NotImplementedError`` until their slices land (``ROADMAP.md``
queue 1, items 10 and 13).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import recurrent as rec
from repro_torch.models.common import (ModelConfig, Params, apply_norm, dense_init,
                                       init_norm)

_NOT_PORTED = {
    "C": "the cross-attention block waits for ROADMAP.md queue 1 item 13 (encoder-decoder)",
}


def _check_kind(cfg: ModelConfig, kind: str) -> None:
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"block kind {kind!r}: {_NOT_PORTED[kind]}")
    if kind not in ("G", "L", "R", "W"):
        raise ValueError(f"unknown block kind {kind!r}")
    if cfg.num_experts:
        raise NotImplementedError("MoE waits for ROADMAP.md queue 1 item 10")


# ----------------------------------------------------------------------
# Dense MLP
# ----------------------------------------------------------------------
def init_mlp(cfg: ModelConfig, gen: torch.Generator, device,
             lead: tuple[int, ...] = ()) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    p = {"wi": dense_init(gen, (*lead, d, ff), cfg.dtype, device, in_axis_size=d),
         "wo": dense_init(gen, (*lead, ff, d), cfg.dtype, device, in_axis_size=ff)}
    if cfg.mlp_gated:
        p["wg"] = dense_init(gen, (*lead, d, ff), cfg.dtype, device, in_axis_size=d)
    return p


def mlp_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["wi"]
    if cfg.mlp_gated:
        g = x @ p["wg"]
        h = h * F.silu(g.float()).to(h.dtype)
    else:
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    return h @ p["wo"]


# ----------------------------------------------------------------------
# Block init / apply
# ----------------------------------------------------------------------
def init_block(cfg: ModelConfig, kind: str, gen: torch.Generator, device,
               lead: tuple[int, ...] = ()) -> Params:
    _check_kind(cfg, kind)
    if kind == "W":
        return {"norm1": init_norm(cfg, device, lead),
                "time_mix": rec.init_rwkv_time_mix(cfg, gen, device, lead),
                "norm2": init_norm(cfg, device, lead),
                "channel_mix": rec.init_rwkv_channel_mix(cfg, gen, device, lead)}
    if kind == "R":
        mixer = {"rglru": rec.init_rglru_block(cfg, gen, device, lead)}
    else:
        mixer = {"attn": attn.init_attention(cfg, gen, device, lead)}
    return {"norm1": init_norm(cfg, device, lead), **mixer,
            "norm2": init_norm(cfg, device, lead),
            "mlp": init_mlp(cfg, gen, device, lead)}


def apply_block(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The block's output.  The reference's MoE aux loss is 0 for the dense
    MLP, the only one ported, so it is not returned."""
    _check_kind(cfg, kind)
    h = apply_norm(cfg, p["norm1"], x)
    if kind == "W":
        x = x + rec.rwkv_time_mix(cfg, p["time_mix"], h)
        h = apply_norm(cfg, p["norm2"], x)
        return x + rec.rwkv_channel_mix(cfg, p["channel_mix"], h)
    if kind == "R":
        x = x + rec.rglru_block(cfg, p["rglru"], h)
    else:
        window = cfg.sliding_window if kind == "L" else None
        x = x + attn.attention_fwd(cfg, p["attn"], h, causal=True, window=window)
    h = apply_norm(cfg, p["norm2"], x)
    return x + mlp_apply(cfg, p["mlp"], h)
