"""GQA attention: parameters, projections with QKV bias, RoPE, the
full-sequence forward (self-attention, or cross-attention from ``kv_src``),
and the KV-cache decode.

Counterpart of :mod:`repro.models.attention`.  The inner attention math
is :func:`repro_torch.kernels.ops.attention` (the Hopper kernels on CUDA,
the chunked or plain attention on the CPU) and, in decode,
:func:`repro_torch.kernels.ops.decode_attention` and
``decode_attention_partials`` (plain torch everywhere, as in the
reference).  The sequence-sharded decode (the reference's
``_decode_attention_seq_sharded``, its distributed flash-decode) runs over
a process group: ``seq_axis`` is a :class:`repro_torch.comm.sync.Comm`
(:func:`decode_attention_seq_sharded`).

**Tensor parallelism** (``tp``, :mod:`repro_torch.comm.tensor_parallel`).
Where the rules split the q heads over ``model`` (H divides it), ``wq``
holds this rank's heads and ``wo`` is row-parallel over them: its product
is all-reduced.  ``wk`` / ``wv`` hold this rank's kv heads where K divides
``model`` too; else they are whole, and the rank takes the kv heads its q
heads read (:func:`repro_torch.comm.tensor_parallel.kv_heads`).  The
flash operators then run at the local (H, K).  Where H does not divide
``model`` every leaf is whole and the attention is replicated on the
``model`` ranks, with no collective.  In decode the q heads (and split kv
heads) are gathered, the cache is attended whole over its own layout (its
sequence over ``seq_axis``; its head dim over ``model`` in the batch-1
layout, whose scores are then summed over ``model`` before the softmax),
and the rank takes its heads back for ``wo``.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist

from repro_torch.comm.tensor_parallel import (TensorParallel, copy_to_model,
                                              gather_from_model, kv_heads, reduce_from_model,
                                              row_parallel)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF
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


def split_heads(cfg: ModelConfig, p: Params, tp: TensorParallel | None) -> bool:
    """Whether this rank holds a block of the q heads (module docstring)."""
    return tp is not None and p["wq"].shape[-2] < cfg.num_heads


def _project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, kv_src: torch.Tensor,
                 tp: TensorParallel | None = None):
    """q from ``x``; k and v from ``kv_src`` (``x`` itself in self-attention).
    With the heads split, this rank's q heads and the kv heads they read:
    ``x``, ``kv_src`` and the whole leaves it takes heads from go through
    one :func:`~repro_torch.comm.tensor_parallel.copy_to_model`."""
    if not split_heads(cfg, p, tp):
        q, k, v = _proj(x, p["wq"]), _proj(kv_src, p["wk"]), _proj(kv_src, p["wv"])
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        return q, k, v
    cross = kv_src is not x
    whole_kv = p["wk"].shape[-2] == cfg.kv_heads
    leaves = ([p["wk"], p["wv"]] if whole_kv else []) + (
        [p["bq"], p["bk"], p["bv"]] if cfg.qkv_bias else [])
    extra = ([kv_src] if cross else []) + leaves
    copied = copy_to_model(tp, x, *extra)
    x, rest = (copied[0], list(copied[1:])) if extra else (copied, [])
    kv_src = rest.pop(0) if cross else x
    if whole_kv:
        idx, _ = kv_heads(cfg.num_heads, cfg.kv_heads, tp.size, tp.index)
        wk, wv = (_heads(w, idx, 1) for w in rest[:2])
        rest = rest[2:]
    else:
        wk, wv = p["wk"], p["wv"]
    q, k, v = _proj(x, p["wq"]), _proj(kv_src, wk), _proj(kv_src, wv)
    if cfg.qkv_bias:
        bq, bk, bv = rest
        q = q + tp.take(bq, 0)
        k, v = (k + _heads(bk, idx, 0), v + _heads(bv, idx, 0)) if whole_kv else (
            k + tp.take(bk, 0), v + tp.take(bv, 0))
    return q, k, v


def _heads(t: torch.Tensor, idx: list[int], dim: int) -> torch.Tensor:
    """The heads ``idx`` of ``t`` along ``dim``: a view where they are a
    run, else a copy."""
    if idx == list(range(idx[0], idx[0] + len(idx))):
        return t.narrow(dim, idx[0], len(idx))
    return torch.cat([t.narrow(dim, i, 1) for i in idx], dim)


def _out_proj(p: Params, out: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    """(B, S, H, hd) @ ``wo`` -> (B, S, d); summed over ``model`` given
    ``tp`` (this rank's heads of a row-parallel ``wo``)."""
    B, S = out.shape[:2]
    H, hd, d = p["wo"].shape
    return row_parallel(tp, out.reshape(B, S, H * hd), p["wo"].reshape(H * hd, d))


def attention_fwd(cfg: ModelConfig, p: Params, x: torch.Tensor, *, causal: bool = True,
                  window: int | None = None, kv_src: torch.Tensor | None = None,
                  use_rope: bool = True, tp: TensorParallel | None = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  Self-attention at positions ``arange(S)``,
    rotated unless ``use_rope`` is False (the encoder's bidirectional
    attention passes ``causal=False`` and keeps RoPE, as the reference
    does); or, given ``kv_src`` (B, S_kv, d), cross-attention: k and v
    projected from ``kv_src``, no RoPE and no causal mask (reference
    ``attention_fwd``: ``causal and not cross``).  ``tp``: tensor
    parallelism (module docstring)."""
    B, S, _ = x.shape
    cross = kv_src is not None
    split = split_heads(cfg, p, tp)
    q, k, v = _project_qkv(cfg, p, x, kv_src if cross else x, tp if split else None)
    if use_rope and not cross:
        pos = torch.arange(S, device=x.device).expand(B, S)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = kops.attention(q, k, v, causal=causal and not cross, window=window)
    return _out_proj(p, out, tp if split else None)


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
                     *, window: int | None = None, seq_axis=None,
                     tp: TensorParallel | None = None) -> tuple[torch.Tensor, Params]:
    """One decode step: x (B, 1, d) at position ``pos`` (a Python int, so
    that the slot and the mask are computed on the host) -> ((B, 1, d),
    cache).  The new token's k and v, rotated first, are written into the
    cache in place, at ``pos`` or, in a ring buffer (``window``), at ``pos
    % cache_len``; the returned cache is the one passed in.  Its contents
    equal the reference's one-hot write slot for slot.  Given ``seq_axis``
    (a :class:`repro_torch.comm.sync.Comm`), ``cache`` is this rank's slice
    of a sequence-sharded cache (:func:`decode_attention_seq_sharded`).
    ``tp``: tensor parallelism (module docstring); the cache holds every kv
    head, its head dim whole or split over ``model``."""
    if isinstance(seq_axis, str):
        raise TypeError(f"seq_axis takes a repro_torch.comm.sync.Comm whose group spans the "
                        f"cache's shards, not the mesh axis name {seq_axis!r}: the port has "
                        "no mesh to resolve a name in")
    B = x.shape[0]
    split = split_heads(cfg, p, tp)
    if split:       # every head, from this rank's blocks
        q, k_new, v_new = (_proj(x, p[w]) for w in ("wq", "wk", "wv"))
        q = gather_from_model(tp, q, -2)
        if p["wk"].shape[-2] < cfg.kv_heads:
            k_new, v_new = gather_from_model(tp, k_new, -2), gather_from_model(tp, v_new, -2)
        if cfg.qkv_bias:
            q, k_new, v_new = q + p["bq"], k_new + p["bk"], v_new + p["bv"]
    else:
        q, k_new, v_new = _project_qkv(cfg, p, x, x)
    if cache["k"].shape[-2] != cfg.kv_heads:
        raise NotImplementedError("a decode cache split over its kv heads: the rules give "
                                  "none in the dry-run matrix")
    posb = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)
    hd_split = cache["k"].shape[-1] < cfg.head_size
    extra = {}
    if hd_split:    # the cache holds this rank's block of the head dim
        k_new, v_new = tp.take(k_new, -1), tp.take(v_new, -1)
        extra = {"partials": functools.partial(_partials_hd_split, tp=tp)}
    if seq_axis is None:
        out = _decode_local(q, k_new, v_new, cache, pos, window, **extra)
    else:
        out = decode_attention_seq_sharded(q, k_new, v_new, cache, pos, seq_axis,
                                           window=window, **extra)
    if hd_split:
        out = gather_from_model(tp, out, -1)
    if split:
        out = tp.take(out, -2)
    return _out_proj(p, out, tp if split else None), cache


def _partials_hd_split(q, k, v, valid, tp: TensorParallel):
    """The flash partials of ``kops.decode_attention_partials`` for a cache
    whose head dim is split over ``model``: q (B, 1, H, hd) whole, k and v
    (B, S, K, hd / m) this rank's block.  The scores are this rank's
    partial dot products summed over ``model`` (one all-reduce) before the
    softmax; o is this rank's block of the head dim."""
    B, _, H, hd = q.shape
    K = k.shape[2]
    qh = tp.take(q, -1).reshape(B, K, H // K, k.shape[-1])
    scores = reduce_from_model(tp, torch.einsum("bkgh,bskh->bkgs", qh.float(), k.float()))
    scores = scores / math.sqrt(hd)
    mask = valid[None, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)
    p = torch.where(mask, torch.exp(scores - m[..., None]), torch.zeros_like(scores))
    o = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    return o.reshape(B, 1, H, -1), m.reshape(B, 1, H), p.sum(dim=-1).reshape(B, 1, H)


def _slot_and_last(pos: int, cache_len: int, window) -> tuple[int, int]:
    """The slot the token at ``pos`` is written to and the last valid slot
    of a cache of ``cache_len`` slots: a ring buffer (``window``) holds the
    last ``cache_len`` tokens, and once it has wrapped every slot is
    valid; a full cache indexes the absolute position."""
    if window:
        slot = pos % cache_len
        return slot, (cache_len - 1 if pos >= cache_len else slot)
    if not 0 <= pos < cache_len:
        raise ValueError(f"position {pos} outside the cache of {cache_len}")
    return pos, pos


def _decode_local(q, k_new, v_new, cache: Params, pos: int, window,
                  partials=kops.decode_attention_partials) -> torch.Tensor:
    cache_len = cache["k"].shape[-3]
    slot, last = _slot_and_last(pos, cache_len, window)
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    valid = torch.arange(cache_len, device=q.device) <= last
    if partials is kops.decode_attention_partials:
        return kops.decode_attention(q, cache["k"], cache["v"], valid)
    o, _, l = partials(q, cache["k"], cache["v"], valid)
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def decode_attention_seq_sharded(q, k_new, v_new, cache: Params, pos: int, comm, *,
                                 window: int | None = None,
                                 partials=kops.decode_attention_partials) -> torch.Tensor:
    """The distributed flash-decode (reference
    ``_decode_attention_seq_sharded``): rank r of ``comm``'s group holds
    slots [r·S_loc, (r+1)·S_loc) of the cache, S_loc = ``cache["k"]``'s
    sequence length.  The owning rank writes the new k and v; each rank
    takes its local flash partials (o, m, l) over its valid slots; they are
    combined with an all-reduce MAX of m, then SUMs of ``o·exp(m - m_glob)``
    and ``l·exp(m - m_glob)``: three all-reduces of B·H·(hd + 2)·4 bytes.
    Returns ``o / max(l, 1e-30)`` (B, 1, H, hd) in q's dtype.  ``partials``
    computes (o, m, l) of the local slots (the head-dim split's, under
    tensor parallelism).

    The reference passes ``seq_axis`` to ``G`` blocks only and leaves a
    sequence-sharded ring buffer (the rules shard every (B, S, K, hd)
    cache leaf at batch 1) to XLA's partitioner.  The port has no
    partitioner, so an ``L`` block's ring buffer (``window``) takes the same
    combine: the slot is ``pos % cache_len`` in the whole ring's
    coordinates (cache_len = world·S_loc), and a slot is valid up to the
    one-rank path's ``last``.  This is where the port departs from the
    reference's code; the result is the one-rank decode's."""
    S_loc = cache["k"].shape[-3]
    offset = comm.rank * S_loc
    slot, last = _slot_and_last(pos, comm.world * S_loc, window)
    if offset <= slot < offset + S_loc:
        cache["k"][:, slot - offset] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot - offset] = v_new[:, 0].to(cache["v"].dtype)
    valid = torch.arange(offset, offset + S_loc, device=q.device) <= last
    o, m, l = partials(q, cache["k"], cache["v"], valid)
    m_glob = m.clone()
    comm.all_reduce(m_glob, op=dist.ReduceOp.MAX)
    scale = torch.exp(m - m_glob)
    o = o * scale[..., None]
    l = l * scale
    comm.all_reduce(o)
    comm.all_reduce(l)
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
