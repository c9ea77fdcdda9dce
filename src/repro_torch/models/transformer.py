"""Decoder-only LM over ``layer_pattern`` block sequences.

Counterpart of :mod:`repro.models.transformer`.  The parameters are
nested dicts keyed exactly like the JAX pytree, with the stacked ``units``
leaves keeping their leading unit axis, so payload bytes and bucket
partitions match the reference by construction; the decode cache
(:func:`init_cache`) is keyed and stacked the same way.  The reference's
``lax.scan`` over units is a Python loop over unit slices; ``param_hook``
is applied to each unit's slice inside the loop and to the unscanned
leaves at their use sites, as in the reference.  ``remat`` recomputes each
unit in the backward pass (``torch.utils.checkpoint``, the counterpart of
``jax.checkpoint(unit_body)``), so the kernels' forward launches double.
``constrain`` (sharding annotations) has no counterpart here.
``encoder_out`` (B, S_enc, d) is what the ``C`` blocks cross-attend to:
the whisper encoder's states (:mod:`repro_torch.models.encdec`) or
llama-vision's stub image embeddings.

Decode (:func:`decode_step`) runs under ``torch.no_grad`` and writes the
cache in place (the reference returns a new one); ``pos`` is a Python int,
so that no cache slot or mask waits on the device.

**Tensor parallelism** (``tp``, :mod:`repro_torch.comm.tensor_parallel`;
the ``fsdp`` mode and ``pure_dp`` on a mesh with ``model``): the blocks
run on this rank's slices, and where the rules split the vocabulary over
``model`` the embedding is vocab-parallel (a lookup of the rank's rows,
zero elsewhere, all-reduced) and the head column-parallel, tied or not, so
:func:`forward` and :func:`decode_step` return this rank's block of the
vocabulary's logits and :func:`loss_fn` takes the vocab-parallel
cross-entropy of :mod:`repro_torch.models.loss`.
"""
from __future__ import annotations

import contextvars
from typing import Callable, Iterator

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import tracing
from repro_torch.comm.tensor_parallel import TensorParallel, copy_to_model, reduce_from_model
from repro_torch.models import blocks as B
from repro_torch.models.common import ModelConfig, Params, apply_norm, dense_init, init_norm

#: ``hook(tree, path, unit)`` -> tree: ``path`` is the key path of the
#: tree's root in the parameter dict, ``unit`` the unit index for slices of
#: the stacked ``units`` leaves (None for unscanned leaves).
ParamHook = Callable[[Params, tuple, "int | None"], Params]


# ----------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------
def make_generator(seed: int, device) -> torch.Generator | None:
    """A generator on ``device`` seeded with ``seed``; None on the meta
    device (shapes only), which takes none."""
    device = torch.device(device)
    return None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)


def init_lm(cfg: ModelConfig, seed: int = 0, device="cpu") -> Params:
    """Random parameters from ``seed`` (a ``torch.Generator`` on
    ``device``; ``device="meta"`` gives shapes only).  The layout equals
    ``repro.models.transformer.init_lm``'s; the values do not (the two
    RNGs differ; :func:`from_reference` carries the reference's over)."""
    device = torch.device(device)
    gen = make_generator(seed, device)
    params: Params = {
        "embedding": dense_init(gen, (cfg.vocab_size, cfg.d_model), cfg.dtype, device,
                                in_axis_size=cfg.d_model),
        "final_norm": init_norm(cfg, device),
    }
    if cfg.num_units > 0:
        lead = (cfg.num_units,)
        params["units"] = {f"b{i}": B.init_block(cfg, kind, gen, device, lead)
                           for i, kind in enumerate(cfg.layer_pattern)}
    for i, kind in enumerate(cfg.remainder_pattern):
        params[f"rem{i}"] = B.init_block(cfg, kind, gen, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), cfg.dtype, device)
    return params


def leaf_order(params: Params, prefix: tuple = ()) -> Iterator[tuple[tuple, torch.Tensor]]:
    """``(key path, leaf)`` in ``jax.tree_util.tree_flatten`` order (dict
    keys sorted at every level, lists in index order, an index an int in
    the path: the encoder's layer list)."""
    if isinstance(params, dict):
        for key in sorted(params):
            yield from leaf_order(params[key], prefix + (key,))
    elif isinstance(params, list):
        for i, item in enumerate(params):
            yield from leaf_order(item, prefix + (i,))
    else:
        yield prefix, params


def get_path(params: Params, path: tuple):
    for key in path:
        params = params[key]
    return params


def map_leaves(fn, params: Params, prefix: tuple = ()) -> Params:
    """A tree of ``fn(path, leaf)`` with ``params``' keys and lists."""
    if isinstance(params, dict):
        return {k: map_leaves(fn, v, prefix + (k,)) for k, v in params.items()}
    if isinstance(params, list):
        return [map_leaves(fn, v, prefix + (i,)) for i, v in enumerate(params)]
    return fn(prefix, params)


def param_count(params: Params) -> int:
    return sum(leaf.numel() for _, leaf in leaf_order(params))


def unit_slice(units: Params, i: int) -> Params:
    return map_leaves(lambda _, leaf: leaf[i], units)


# ----------------------------------------------------------------------
# Forward (train)
# ----------------------------------------------------------------------
def _sum_aux(auxes: list) -> torch.Tensor | None:
    auxes = [a for a in auxes if a is not None]
    return sum(auxes) if auxes else None


def vocab_split(cfg: ModelConfig, emb: torch.Tensor,
                tp: TensorParallel | None) -> TensorParallel | None:
    """``tp`` where the embedding ``emb`` holds a block of the vocabulary,
    else None."""
    return tp if tp is not None and emb.shape[0] < cfg.vocab_size else None


def embed(cfg: ModelConfig, emb: torch.Tensor, tokens: torch.Tensor,
          tp: TensorParallel | None = None) -> torch.Tensor:
    """The embeddings of ``tokens``; vocab-parallel under ``tp`` (module
    docstring)."""
    tp = vocab_split(cfg, emb, tp)
    if tp is None:
        return emb[tokens]
    start, stop = tp.block(cfg.vocab_size)
    local = tokens - start
    inside = (local >= 0) & (local < stop - start)
    rows = emb[local.clamp(0, stop - start - 1)]
    return reduce_from_model(tp, torch.where(inside[..., None], rows, torch.zeros_like(rows)))


def _head_input(cfg: ModelConfig, head: torch.Tensor, x: torch.Tensor,
                tp: TensorParallel | None) -> tuple[torch.Tensor, TensorParallel | None]:
    """(x, ``tp`` if the head is column-parallel over the vocabulary, else
    None); x through :func:`~repro_torch.comm.tensor_parallel.copy_to_model`
    in the first case."""
    tp = tp if tp is not None and head.shape[-1] < cfg.vocab_size else None
    return copy_to_model(tp, x), tp


def _final_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
                  encoder_out: torch.Tensor | None = None, remat: bool = False,
                  param_hook: ParamHook | None = None, tp: TensorParallel | None = None):
    """(final hidden states, head, the MoE aux loss summed over every
    block; None without experts).  The hidden states pass a
    :func:`repro_torch.tracing.boundary` before each unit (before its
    parameter slice, outside the recompute) and after the last."""
    ph = param_hook or (lambda p, path, unit=None: p)
    emb = ph(params["embedding"], ("embedding",), None)
    x = embed(cfg, emb, tokens, tp)

    def unit_body(x, u):
        unit_params = ph(unit_slice(params["units"], u), ("units",), u)
        auxes = []
        for i, kind in enumerate(cfg.layer_pattern):
            x, a = B.apply_block(cfg, kind, unit_params[f"b{i}"], x, encoder_out, tp)
            auxes.append(a)
        return x, _sum_aux(auxes)

    auxes = []
    for u in range(cfg.num_units):
        x = tracing.boundary(x, "unit", u)
        if remat:
            # the recompute runs on the autograd engine's device thread on
            # CUDA: it sees this call's context variables through a copy of
            # them (the MoE aux loss's batch, moe.aux_over_batch)
            x, a = torch.utils.checkpoint.checkpoint(contextvars.copy_context().run, unit_body,
                                                     x, u, use_reentrant=False)
        else:
            x, a = unit_body(x, u)
        auxes.append(a)
    x = tracing.boundary(x, "head")
    for i, kind in enumerate(cfg.remainder_pattern):
        x, a = B.apply_block(cfg, kind, ph(params[f"rem{i}"], (f"rem{i}",), None), x,
                             encoder_out, tp)
        auxes.append(a)
    aux = _sum_aux(auxes)
    x = apply_norm(cfg, ph(params["final_norm"], ("final_norm",), None), x)
    head = emb.T if cfg.tie_embeddings else ph(params["lm_head"], ("lm_head",), None)
    return x, head, aux


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            encoder_out: torch.Tensor | None = None, remat: bool = False,
            param_hook: ParamHook | None = None,
            tp: TensorParallel | None = None) -> torch.Tensor:
    """tokens: (B, S) int -> logits (B, S, V) in logit_dtype (this rank's
    block of V where ``tp`` splits the vocabulary).  The reference also
    returns the MoE aux loss; :func:`loss_fn` returns it here."""
    x, head, _ = _final_hidden(cfg, params, tokens, encoder_out=encoder_out, remat=remat,
                               param_hook=param_hook, tp=tp)
    x, _ = _head_input(cfg, head, x, tp)
    return (x @ head).to(cfg.logit_dtype)


# Vocab sizes at or above this use the chunked cross-entropy.
CHUNKED_XENT_MIN_VOCAB = 16_384

# The MoE aux loss's weight in the total (reference transformer.py:123).
MOE_AUX_WEIGHT = 0.01


def loss_fn(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            labels: torch.Tensor, *, encoder_out: torch.Tensor | None = None,
            remat: bool = False, param_hook: ParamHook | None = None,
            tp: TensorParallel | None = None) -> tuple[torch.Tensor, dict]:
    """(cross-entropy + ``MOE_AUX_WEIGHT`` x the MoE aux loss, {"loss": the
    cross-entropy, "moe_aux": the aux loss}).  Without experts the
    reference's aux is 0: the total is the cross-entropy itself and
    ``moe_aux`` is left out, so dense blocks launch nothing for it."""
    from repro_torch.models.loss import chunked_cross_entropy, vocab_parallel_cross_entropy

    x, head, aux = _final_hidden(cfg, params, tokens, encoder_out=encoder_out, remat=remat,
                                 param_hook=param_hook, tp=tp)
    x, tp_v = _head_input(cfg, head, x, tp)
    if cfg.vocab_size >= CHUNKED_XENT_MIN_VOCAB:
        loss = chunked_cross_entropy(x, head, labels, tp=tp_v)
    elif tp_v is not None:
        loss = vocab_parallel_cross_entropy((x @ head).to(cfg.logit_dtype), labels, tp_v)
    else:
        logits = (x @ head).to(cfg.logit_dtype)
        logp = torch.log_softmax(logits, dim=-1)
        loss = -torch.gather(logp, -1, labels[..., None])[..., 0].mean()
    if aux is None:
        return loss, {"loss": loss}
    return loss + MOE_AUX_WEIGHT * aux, {"loss": loss, "moe_aux": aux}


# ----------------------------------------------------------------------
# Decode (serve_step)
# ----------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device="cpu") -> Params:
    """The zero decode cache: ``units`` (each leaf with the leading
    ``num_units`` axis) and ``rem{i}``, keyed like the reference's."""
    cache: Params = {}
    if cfg.num_units > 0:
        cache["units"] = {f"b{i}": B.init_block_cache(cfg, kind, batch, seq_len, device,
                                                      lead=(cfg.num_units,))
                          for i, kind in enumerate(cfg.layer_pattern)}
    for i, kind in enumerate(cfg.remainder_pattern):
        cache[f"rem{i}"] = B.init_block_cache(cfg, kind, batch, seq_len, device)
    return cache


def _write_back(cache: Params, new: Params) -> None:
    """Copy a block's new state into its cache slice, leaf by leaf (a leaf
    the block wrote in place is the same tensor, and is left alone)."""
    for key, t in new.items():
        if t is not cache[key]:
            cache[key].copy_(t)


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Params, cache: Params, token: torch.Tensor,
                pos: int, *, encoder_out: torch.Tensor | None = None,
                seq_axis=None, param_hook: ParamHook | None = None,
                tp: TensorParallel | None = None) -> tuple[torch.Tensor, Params]:
    """One-token decode: token (B,) int at position ``pos`` (a Python int).
    Returns (logits (B, V) in logit_dtype, cache), the cache updated in
    place.  ``seq_axis``, a :class:`repro_torch.comm.sync.Comm`, makes the
    ``G`` and ``L`` caches this rank's slices of sequence-sharded ones
    (:func:`repro_torch.models.attention.decode_attention_seq_sharded`).
    ``param_hook`` is applied as in :func:`forward`: to each unit's slice
    when that unit runs, and to the unscanned leaves at their use.  ``tp``:
    tensor parallelism (module docstring), the cache this rank's slice by
    the rules; the logits are this rank's block of V where ``tp`` splits
    the vocabulary."""
    ph = param_hook or (lambda p, path, unit=None: p)
    emb = ph(params["embedding"], ("embedding",), None)
    x = embed(cfg, emb, token, tp)[:, None, :]                 # (B, 1, d)

    def run(p, c, kind):
        nonlocal x
        x, new = B.decode_block(cfg, kind, p, x, c, pos, encoder_out=encoder_out,
                                seq_axis=seq_axis, tp=tp)
        _write_back(c, new)

    for u in range(cfg.num_units):
        unit_params = ph(unit_slice(params["units"], u), ("units",), u)
        unit_cache = unit_slice(cache["units"], u)
        for i, kind in enumerate(cfg.layer_pattern):
            run(unit_params[f"b{i}"], unit_cache[f"b{i}"], kind)
    for i, kind in enumerate(cfg.remainder_pattern):
        run(ph(params[f"rem{i}"], (f"rem{i}",), None), cache[f"rem{i}"], kind)
    x = apply_norm(cfg, ph(params["final_norm"], ("final_norm",), None), x)
    head = emb.T if cfg.tie_embeddings else ph(params["lm_head"], ("lm_head",), None)
    x, _ = _head_input(cfg, head, x, tp)
    return (x @ head).to(cfg.logit_dtype)[:, 0, :], cache


@torch.no_grad()
def prefill_via_decode(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                       seq_len: int, *, encoder_out: torch.Tensor | None = None,
                       ) -> tuple[torch.Tensor, Params]:
    """Sequential prefill (the serving example's, for small models): the
    tokens (B, S) fed one at a time through :func:`decode_step` into a
    fresh cache of ``seq_len``.  Returns (logits (B, S, V), cache)."""
    cache = init_cache(cfg, tokens.shape[0], seq_len, device=tokens.device)
    logits = [decode_step(cfg, params, cache, tokens[:, t], t, encoder_out=encoder_out)[0]
              for t in range(tokens.shape[1])]
    return torch.stack(logits, dim=1), cache


# ----------------------------------------------------------------------
# Parameter bridge from the reference
# ----------------------------------------------------------------------
def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def from_reference(tree: Params, device="cpu") -> Params:
    """The port's parameters from the reference's parameter pytree given as
    nested dicts (and lists) of numpy arrays (``jax.tree_util.tree_map(
    np.asarray, params)``), key path for key path, dtypes kept."""
    return map_leaves(lambda _, arr: _to_tensor(arr, device), tree)
