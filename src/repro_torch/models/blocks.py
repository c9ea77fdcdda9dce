"""Block registry: ``G`` (global attention + MLP), ``L`` (sliding-window
attention + MLP), ``R`` (RG-LRU recurrent block + MLP), ``C`` (causal
self-attention, cross-attention to the encoder's states, MLP: the whisper
decoder's and llama-vision's image layers), pre-norm residual, with the MLP
a mixture of experts when the config has experts, else dense (gated SiLU
or GELU); and ``W`` (RWKV6 time mix + channel mix, pre-norm residual, no
MLP).

Counterpart of :mod:`repro.models.blocks` lines 28-190: init, the train /
prefill apply, and the decode pair (:func:`init_block_cache`,
:func:`decode_block`).  A ``C`` block's decode cache is its self-attention
cache only: as in the reference, its cross-attention is recomputed from
``encoder_out`` at every token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.comm.tensor_parallel import TensorParallel, copy_to_model, row_parallel
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec
from repro_torch.models.common import (ModelConfig, Params, apply_norm, dense_init,
                                       init_norm)

def _check_kind(cfg: ModelConfig, kind: str) -> None:
    if kind not in ("G", "L", "R", "W", "C"):
        raise ValueError(f"unknown block kind {kind!r}")


def _check_encoder(kind: str, encoder_out) -> None:
    if kind == "C" and encoder_out is None:
        raise ValueError("a C block cross-attends: it needs encoder_out")


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


def mlp_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
              tp: TensorParallel | None = None) -> torch.Tensor:
    """The MLP; under tensor parallelism (``tp``, the hidden split over
    ``model``) a column-parallel ``wi`` / ``wg`` and a row-parallel ``wo``,
    whose product is all-reduced."""
    tp = tp if tp is not None and p["wi"].shape[-1] < cfg.d_ff else None
    x = copy_to_model(tp, x)
    h = x @ p["wi"]
    if cfg.mlp_gated:
        g = x @ p["wg"]
        h = h * F.silu(g.float()).to(h.dtype)
    else:
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    return row_parallel(tp, h, p["wo"])


def _ffn_init(cfg: ModelConfig, gen: torch.Generator, device,
              lead: tuple[int, ...]) -> Params:
    if cfg.num_experts:
        return {"moe": moe_mod.init_moe(cfg, gen, device, lead)}
    return {"mlp": init_mlp(cfg, gen, device, lead)}


def _ffn_apply(cfg: ModelConfig, p: Params, x: torch.Tensor, tp: TensorParallel | None,
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    if "moe" in p:
        return moe_mod.moe_mlp(cfg, p["moe"], x, tp)
    return mlp_apply(cfg, p["mlp"], x, tp), None


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
    elif kind == "C":
        mixer = {"attn": attn.init_attention(cfg, gen, device, lead),
                 "norm_x": init_norm(cfg, device, lead),
                 "xattn": attn.init_attention(cfg, gen, device, lead)}
    else:
        mixer = {"attn": attn.init_attention(cfg, gen, device, lead)}
    return {"norm1": init_norm(cfg, device, lead), **mixer,
            "norm2": init_norm(cfg, device, lead),
            **_ffn_init(cfg, gen, device, lead)}


def _cross(cfg: ModelConfig, p: Params, x: torch.Tensor, encoder_out: torch.Tensor,
           tp: TensorParallel | None = None):
    """A ``C`` block's cross-attention sub-layer, pre-norm residual."""
    h = apply_norm(cfg, p["norm_x"], x)
    return x + attn.attention_fwd(cfg, p["xattn"], h, kv_src=encoder_out, use_rope=False,
                                  tp=tp)


def apply_block(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                encoder_out: torch.Tensor | None = None, tp: TensorParallel | None = None,
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(the block's output, its MoE aux loss in float32; None without
    experts, where the reference's is 0).  ``encoder_out`` (B, S_enc, d):
    the states a ``C`` block attends to.  ``tp``: tensor and expert
    parallelism on ``model`` (:mod:`repro_torch.comm.tensor_parallel`); the
    residual stream ``x`` is whole on every ``model`` rank, as the
    reference's ``constrain(x, "batch", None, None)`` keeps it."""
    _check_kind(cfg, kind)
    _check_encoder(kind, encoder_out)
    h = apply_norm(cfg, p["norm1"], x)
    if kind == "W":
        x = x + rec.rwkv_time_mix(cfg, p["time_mix"], h, tp=tp)[0]
        h = apply_norm(cfg, p["norm2"], x)
        return x + rec.rwkv_channel_mix(cfg, p["channel_mix"], h, tp=tp)[0], None
    if kind == "R":
        x = x + rec.rglru_block(cfg, p["rglru"], h, tp=tp)[0]
    else:
        window = cfg.sliding_window if kind == "L" else None
        x = x + attn.attention_fwd(cfg, p["attn"], h, causal=True, window=window, tp=tp)
        if kind == "C":
            x = _cross(cfg, p, x, encoder_out, tp)
    h = apply_norm(cfg, p["norm2"], x)
    y, aux = _ffn_apply(cfg, p, h, tp)
    return x + y, aux


# ----------------------------------------------------------------------
# Decode (serve_step): one token + cache
# ----------------------------------------------------------------------
def init_block_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int, device="cpu",
                     lead: tuple[int, ...] = ()) -> Params:
    """The zero decode state of one block, with the leading axes ``lead``:
    ``G`` and ``C`` a full kv cache (a ``C`` block's self-attention only),
    ``L`` a ring buffer of ``min(seq_len, sliding_window)`` slots, ``R``
    the scan state ``h`` (f32) and the conv state, ``W`` the wkv state
    ``S`` (f32) and the two mixers' last tokens."""
    _check_kind(cfg, kind)
    if kind in ("G", "L", "C"):
        return attn.init_kv_cache(cfg, batch, seq_len,
                                  window=cfg.sliding_window if kind == "L" else None,
                                  device=device, lead=lead)
    if kind == "R":
        W, kw = cfg.rnn_size, cfg.conv1d_width
        return {"h": torch.zeros((*lead, batch, W), dtype=torch.float32, device=device),
                "conv": torch.zeros((*lead, batch, kw - 1, W), dtype=cfg.dtype, device=device)}
    H, hd, d = rec.rwkv_heads(cfg), rec.RWKV_HEAD_DIM, cfg.d_model
    return {"S": torch.zeros((*lead, batch, H, hd, hd), dtype=torch.float32, device=device),
            "x_prev_tm": torch.zeros((*lead, batch, d), dtype=cfg.dtype, device=device),
            "x_prev_cm": torch.zeros((*lead, batch, d), dtype=cfg.dtype, device=device)}


def decode_block(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor, cache: Params,
                 pos: int, encoder_out: torch.Tensor | None = None,
                 seq_axis=None, tp: TensorParallel | None = None,
                 ) -> tuple[torch.Tensor, Params]:
    """x: (B, 1, d) at position ``pos`` -> (x, new cache).  ``seq_axis``
    (a :class:`repro_torch.comm.sync.Comm`) makes the ``G``, ``L`` and
    ``C`` caches this rank's slices of sequence-sharded ones (the reference
    shards ``G`` only; :func:`repro_torch.models.attention.
    decode_attention_seq_sharded` says why the others too).  An attention
    block's new cache is ``cache`` itself, written in place; a recurrent
    block's holds new tensors.  A ``C`` block attends from the token to all
    of ``encoder_out``, recomputing that attention's k and v each call.
    ``tp``: as in :func:`apply_block`; the cache is this rank's slice by
    the rules (:func:`repro_torch.models.sharding.cache_specs`)."""
    _check_kind(cfg, kind)
    _check_encoder(kind, encoder_out)
    h = apply_norm(cfg, p["norm1"], x)
    if kind == "W":
        y, tm = rec.rwkv_time_mix(cfg, p["time_mix"], h,
                                  state={"S": cache["S"], "x_prev": cache["x_prev_tm"]}, tp=tp)
        x = x + y
        h = apply_norm(cfg, p["norm2"], x)
        y, x_prev_cm = rec.rwkv_channel_mix(cfg, p["channel_mix"], h,
                                            x_prev=cache["x_prev_cm"], tp=tp)
        return x + y, {"S": tm["S"], "x_prev_tm": tm["x_prev"], "x_prev_cm": x_prev_cm}
    if kind == "R":
        y, new_cache = rec.rglru_block(cfg, p["rglru"], h, state=cache, tp=tp)
    else:
        y, new_cache = attn.decode_attention(
            cfg, p["attn"], h, cache, pos, window=cfg.sliding_window if kind == "L" else None,
            seq_axis=seq_axis, tp=tp)
    x = x + y
    if kind == "C":
        x = _cross(cfg, p, x, encoder_out, tp)
    h = apply_norm(cfg, p["norm2"], x)
    return x + _ffn_apply(cfg, p, h, tp)[0], new_cache
