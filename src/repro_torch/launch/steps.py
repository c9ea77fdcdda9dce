"""Step builders: the train, prefill and serve steps.

Counterpart of :mod:`repro.launch.steps` (``init_params``,
``make_train_step``, ``make_prefill_step``, ``make_serve_step``).  The
dry-run's shape-only pieces, ``params_shape`` and ``input_specs``, wait for
the shape-only lowering (``ROADMAP.md`` queue 1, item 9); the
encoder-decoder branch waits for item 8.  A step updates the parameters
and optimizer state in place (:mod:`repro_torch.optim.sgd`) and returns
them.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.optim.sgd import Optimizer, global_norm


def init_params(cfg: ModelConfig, seed: int = 0, device="cpu"):
    return T.init_lm(cfg, seed=seed, device=device)


def loss_and_grads(cfg: ModelConfig, params, tokens, labels, remat: bool = False,
                   param_hook: T.ParamHook | None = None):
    """(total loss, metrics, gradients keyed like ``params``): the port's
    ``loss_fn``, then ``torch.autograd.grad`` over every leaf."""
    paths, leaves = zip(*T.leaf_order(params))
    for leaf in leaves:
        leaf.requires_grad_(True)
    try:
        total, metrics = T.loss_fn(cfg, params, tokens.long(), labels.long(), remat=remat,
                                   param_hook=param_hook)
        grad_list = torch.autograd.grad(total, leaves)
    finally:
        for leaf in leaves:
            leaf.requires_grad_(False)
    grads = dict(zip(paths, grad_list))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total.detach(), metrics, T.map_leaves(lambda path, _: grads[path], params)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *, remat: bool = True,
                    accum_steps: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: loss -> gradients -> optimizer update; ``batch`` holds
    ``tokens`` and ``labels`` (B, S).  ``remat`` recomputes each unit in the
    backward pass.  ``accum_steps > 1`` splits the batch into that many
    microbatches and sums their gradients in float32, then scales by 1 /
    ``accum_steps``; the metrics are the microbatches' means, as in the
    reference.  ``metrics``: ``total_loss``, ``loss``, ``moe_aux`` (0
    without experts) and ``grad_norm``."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def train_step(params, opt_state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        if accum_steps == 1:
            total, metrics, grads = loss_and_grads(cfg, params, tokens, labels, remat)
            loss = metrics["loss"]
            aux = metrics.get("moe_aux", torch.zeros((), device=total.device))
        else:
            if tokens.shape[0] % accum_steps:
                raise ValueError(f"batch {tokens.shape[0]} not divisible into "
                                 f"{accum_steps} microbatches")
            grads = T.map_leaves(lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                                          device=p.device), params)
            total = loss = aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for tok, lab in zip(tokens.chunk(accum_steps), labels.chunk(accum_steps)):
                tot, m, g = loss_and_grads(cfg, params, tok, lab, remat)
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
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"total_loss": total, "loss": loss, "moe_aux": aux,
                                   "grad_norm": global_norm(grads)}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> logits (B, S, V)``, no gradient."""

    @torch.no_grad()
    def prefill_step(params, batch):
        return T.forward(cfg, params, batch["tokens"])

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, seq_axis: str | None = None):
    """``serve_step(params, batch) -> (logits (B, V), cache)``: one-token
    decode; ``batch`` holds ``cache`` (:func:`repro_torch.models.transformer.
    init_cache`), ``token`` (B,) and ``pos`` (a Python int).  The cache is
    updated in place."""

    def serve_step(params, batch):
        return T.decode_step(cfg, params, batch["cache"], batch["token"], batch["pos"],
                             seq_axis=seq_axis)

    return serve_step
