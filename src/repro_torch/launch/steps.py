"""Step builders: the train, prefill and serve steps.

Counterpart of :mod:`repro.launch.steps` (``init_params``,
``make_train_step``, ``make_prefill_step``, ``make_serve_step``), with the
reference's branches: an ``audio`` arch (whisper-tiny) is the
encoder-decoder of :mod:`repro_torch.models.encdec`, fed ``frames`` in
training and prefill and ``encoder_states`` in decode; a ``vlm`` arch
(llama-3.2-vision-90b) is the LM with ``images`` (stub patch embeddings)
as its ``C`` blocks' ``encoder_out``.  The dry run's shape-only pieces,
:func:`params_shape` and :func:`input_specs`, give fake tensors
(``FakeTensorMode``: shapes and dtypes, no storage) with the reference's
tree, key paths, shapes and dtypes.  A step updates the parameters and
optimizer state in place (:mod:`repro_torch.optim.sgd`) and returns them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tracing
from repro_torch.comm.sharded import ShardedHook
from repro_torch.configs.shapes import InputShape
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.models.moe import aux_over_batch
from repro_torch.optim.sgd import Optimizer, global_norm


def dense_backbone(cfg: ModelConfig) -> ModelConfig:
    """The config the launchers run for ``cfg``: an ``audio`` or ``vlm``
    arch trains and serves as its LM backbone alone, every layer a ``G``
    block of type ``dense``, as the reference's launchers do
    (``repro/launch/train.py:60-63``, ``repro/launch/serve.py:37-39``);
    any other arch as it is."""
    if cfg.arch_type in ("audio", "vlm"):
        return dataclasses.replace(cfg, layer_pattern="G", arch_type="dense")
    return cfg


def init_params(cfg: ModelConfig, seed: int = 0, device="cpu"):
    if cfg.arch_type == "audio":
        return ED.init_encdec(cfg, seed=seed, device=device)
    return T.init_lm(cfg, seed=seed, device=device)


def params_shape(cfg: ModelConfig, device="cuda", mode: FakeTensorMode | None = None):
    """The tree :func:`init_params` gives, as fake tensors on ``device``
    under ``mode`` (a new ``FakeTensorMode`` when None): built on the meta
    device (no generator, no draw), each leaf then made a fake tensor of
    its shape and dtype."""
    mode = mode or FakeTensorMode()
    shapes = init_params(cfg, device="meta")
    with mode:
        return T.map_leaves(lambda _, t: torch.empty(t.shape, dtype=t.dtype, device=device),
                            shapes)


def input_specs(cfg: ModelConfig, shape: InputShape, device="cuda",
                mode: FakeTensorMode | None = None, batch: int | None = None) -> dict[str, Any]:
    """The step's batch for ``shape`` as fake tensors on ``device`` under
    ``mode`` (a new ``FakeTensorMode`` when None), keyed as the reference's
    ``input_specs``: ``tokens`` and ``labels`` (train), ``tokens``
    (prefill), ``token``, ``pos`` (an int32 scalar, as the reference's;
    :func:`make_serve_step` takes a Python int there) and ``cache``
    (decode); ``frames`` (audio) or ``images`` (vlm) beside them, and for
    an audio arch's decode ``encoder_states``.  ``batch`` overrides the
    shape's global batch (a rank's share)."""
    mode = mode or FakeTensorMode()
    B, S = batch or shape.global_batch, shape.seq_len
    with mode:
        def sds(dims, dtype):
            return torch.empty(dims, dtype=dtype, device=device)

        enc = {}
        if cfg.arch_type == "audio":
            enc = {"frames" if shape.kind != "decode" else "encoder_states":
                   sds((B, cfg.encoder_seq, cfg.d_model), cfg.dtype)}
        if cfg.arch_type == "vlm":
            enc = {"images": sds((B, cfg.num_image_tokens, cfg.d_model), cfg.dtype)}
        if shape.kind == "train":
            return {"tokens": sds((B, S), torch.int32), "labels": sds((B, S), torch.int32),
                    **enc}
        if shape.kind == "prefill":
            return {"tokens": sds((B, S), torch.int32), **enc}
        if shape.kind == "decode":
            return {"token": sds((B,), torch.int32), "pos": sds((), torch.int32),
                    "cache": T.init_cache(cfg, B, S, device=device), **enc}
    raise ValueError(shape.kind)


#: the batch key of each encoder-fed arch type's encoder input
ENCODER_INPUT = {"audio": "frames", "vlm": "images"}


def encoder_input(cfg: ModelConfig, batch: dict):
    """``frames`` (audio) or ``images`` (vlm) of ``batch``; None for an
    LM-only arch."""
    key = ENCODER_INPUT.get(cfg.arch_type)
    return None if key is None else batch[key]


def model_loss(cfg: ModelConfig, params, tokens, labels, remat: bool = False,
               param_hook: T.ParamHook | None = None, encoder_in=None, tp=None):
    """(total loss, metrics) of the arch's model: the encoder-decoder's
    ``loss_fn`` for an ``audio`` arch (``encoder_in`` the frames), else the
    LM's (``encoder_in`` the images of a ``vlm`` arch, or None).  ``tp``:
    tensor parallelism (:mod:`repro_torch.comm.tensor_parallel`)."""
    if cfg.arch_type == "audio":
        return ED.loss_fn(cfg, params, encoder_in, tokens, labels, remat=remat,
                          param_hook=param_hook, tp=tp)
    return T.loss_fn(cfg, params, tokens, labels, encoder_out=encoder_in, remat=remat,
                     param_hook=param_hook, tp=tp)


def loss_and_grads(cfg: ModelConfig, params, tokens, labels, remat: bool = False,
                   param_hook: T.ParamHook | None = None, encoder_in=None, tp=None):
    """(total loss, metrics, gradients keyed like ``params``): the port's
    ``loss_fn``, then ``torch.autograd.grad`` over every leaf.
    ``encoder_in``: the frames of an ``audio`` arch or the images of a
    ``vlm`` arch (:func:`encoder_input`).  Under :func:`repro_torch.tracing.
    record` the two are the spans ``fwd`` and ``bwd``."""
    paths, leaves = zip(*T.leaf_order(params))
    for leaf in leaves:
        leaf.requires_grad_(True)
    try:
        with tracing.span("fwd"):
            total, metrics = model_loss(cfg, params, tokens.long(), labels.long(), remat,
                                        param_hook, encoder_in, tp)
        with tracing.span("bwd"):
            grad_list = torch.autograd.grad(total, leaves)
    finally:
        for leaf in leaves:
            leaf.requires_grad_(False)
    grads = dict(zip(paths, grad_list))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total.detach(), metrics, T.map_leaves(lambda path, _: grads[path], params)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *, remat: bool = True,
                    accum_steps: int = 1,
                    grad_sync: Callable[[Any], Any] | None = None,
                    sharded: ShardedHook | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: loss -> gradients -> optimizer update; ``batch`` holds
    ``tokens`` and ``labels`` (B, S), and ``frames`` (audio) or ``images``
    (vlm) (B, n, d_model), split with them into microbatches.  ``remat``
    recomputes each unit in the
    backward pass.  ``accum_steps > 1`` splits the batch into that many
    microbatches and sums their gradients in float32, then scales by 1 /
    ``accum_steps``; the metrics are the microbatches' means, as in the
    reference.  ``metrics``: ``total_loss``, ``loss``, ``moe_aux`` (0
    without experts) and ``grad_norm``.  ``grad_sync``, if given, takes the
    gradients before the update and returns them synchronized (for example
    :func:`repro_torch.comm.sync.sync_gradients` over a process group).
    ``sharded`` (:class:`repro_torch.comm.sharded.ShardedHook`): the
    parameters and optimizer state are this rank's shards, gathered per
    unit, and the blocks run its tensor parallelism
    (:attr:`~repro_torch.comm.sharded.ShardedHook.tp`); each microbatch's
    gradients are finished by it
    (:meth:`~repro_torch.comm.sharded.ShardedHook.finish`) and the MoE aux
    loss is taken over the batch of the ranks that split it; ``grad_norm``
    is the whole gradient's.  Under :func:`repro_torch.tracing.record` the
    step is a ``step`` span of ``fwd`` and ``bwd`` (a microbatch each) and
    ``update``."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if sharded is not None and grad_sync is not None:
        raise ValueError("a sharded step synchronizes its own gradients: no grad_sync")

    def grads_of(params, tokens, labels, enc_in):
        if sharded is None:
            return loss_and_grads(cfg, params, tokens, labels, remat, encoder_in=enc_in)
        with aux_over_batch(sharded.batch_comm()):
            total, metrics, grads = loss_and_grads(cfg, params, tokens, labels, remat,
                                                   sharded, enc_in, sharded.tp)
        return total, metrics, sharded.finish(grads)

    @tracing.spanned("step")
    def train_step(params, opt_state, batch):
        tokens, labels, enc_in = batch["tokens"], batch["labels"], encoder_input(cfg, batch)
        if accum_steps == 1:
            total, metrics, grads = grads_of(params, tokens, labels, enc_in)
            loss = metrics["loss"]
            aux = metrics.get("moe_aux", torch.zeros((), device=total.device))
        else:
            if tokens.shape[0] % accum_steps:
                raise ValueError(f"batch {tokens.shape[0]} not divisible into "
                                 f"{accum_steps} microbatches")
            grads = T.map_leaves(lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                                          device=p.device), params)
            total = loss = aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
            encs = [None] * accum_steps if enc_in is None else enc_in.chunk(accum_steps)
            for tok, lab, enc in zip(tokens.chunk(accum_steps), labels.chunk(accum_steps),
                                     encs):
                tot, m, g = grads_of(params, tok, lab, enc)
                for path, acc in T.leaf_order(grads):
                    acc.add_(T.get_path(g, path).float())
                total = total + tot
                loss = loss + m["loss"]
                if "moe_aux" in m:
                    aux = aux + m["moe_aux"]
            inv = 1.0 / accum_steps
            for _, acc in T.leaf_order(grads):
                acc.mul_(inv)
            total, loss, aux = total * inv, loss * inv, aux * inv
        if grad_sync is not None:
            grads = grad_sync(grads)
        params, opt_state = optimizer.update(grads, opt_state, params)
        norm = global_norm(grads) if sharded is None else sharded.global_norm(grads)
        return params, opt_state, {"total_loss": total, "loss": loss, "moe_aux": aux,
                                   "grad_norm": norm}

    return train_step


def make_prefill_step(cfg: ModelConfig, *, sharded: ShardedHook | None = None):
    """``prefill_step(params, batch) -> logits (B, S, V)``, no gradient;
    ``batch`` holds ``tokens``, and ``frames`` or ``images`` as in
    training.  ``sharded``: the parameters are this rank's shards, gathered
    per unit, and the logits this rank's block of the vocabulary where its
    tensor parallelism splits it."""
    tp = sharded.tp if sharded is not None else None

    @torch.no_grad()
    def prefill_step(params, batch):
        if cfg.arch_type == "audio":
            return ED.forward(cfg, params, batch["frames"], batch["tokens"],
                              param_hook=sharded, tp=tp)
        return T.forward(cfg, params, batch["tokens"], encoder_out=encoder_input(cfg, batch),
                         param_hook=sharded, tp=tp)

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, seq_axis=None, sharded: ShardedHook | None = None):
    """``serve_step(params, batch) -> (logits (B, V), cache)``: one-token
    decode; ``batch`` holds ``cache`` (:func:`repro_torch.models.transformer.
    init_cache`), ``token`` (B,) and ``pos`` (a Python int), and for an
    ``audio`` arch ``encoder_states`` (:func:`repro_torch.models.encdec.
    encode` of the frames, computed once a request), for a ``vlm`` arch
    ``images``.  The cache is updated in place.  ``seq_axis``: a
    :class:`repro_torch.comm.sync.Comm` whose group shards the ``G`` and
    ``L`` caches' sequence axis (:func:`repro_torch.models.transformer.
    decode_step`).  ``sharded``: the parameters are this rank's shards,
    gathered per unit at each token; under its tensor parallelism the cache
    is this rank's slice by the rules and the logits its block of the
    vocabulary where that is split."""
    tp = sharded.tp if sharded is not None else None

    def serve_step(params, batch):
        cache, token, pos = batch["cache"], batch["token"], batch["pos"]
        if cfg.arch_type == "audio":
            return ED.decode_step(cfg, params, cache, batch["encoder_states"], token, pos,
                                  param_hook=sharded, seq_axis=seq_axis, tp=tp)
        return T.decode_step(cfg, params, cache, token, pos,
                             encoder_out=encoder_input(cfg, batch), seq_axis=seq_axis,
                             param_hook=sharded, tp=tp)

    return serve_step
