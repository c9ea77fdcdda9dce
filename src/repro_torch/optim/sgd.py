"""Optimizers: SGD with momentum — the paper's algorithm — and AdamW, and
``global_norm``.

Counterpart of :mod:`repro.optim.sgd`, with the same optax-style
interface: ``opt.init(params) -> state`` and ``opt.update(grads, state,
params) -> (params, state)``.  The state (momentum; AdamW's ``m``, ``v``)
and the update math are float32 and the result is cast back to the
parameter dtype, as in the reference.  Unlike the reference, ``update``
writes the new parameters and state in place (at full width a functional
copy would double the memory of both) and returns the same dicts; under
:func:`repro_torch.tracing.record` it is the span ``update``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch import tracing
from repro_torch.models.transformer import Params, get_path, leaf_order, map_leaves


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], tuple[Params, Any]]


def sgd(lr: float, momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"mom": map_leaves(
            lambda _, p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            params)}

    @tracing.spanned("update")
    @torch.no_grad()
    def update(grads, state, params):
        for path, p in leaf_order(params):
            g = get_path(grads, path).float()
            if weight_decay:
                g = g + weight_decay * p.float()
            if momentum:
                m = get_path(state["mom"], path)
                m.mul_(momentum).add_(g)
                g = m
            if p.dtype == torch.float32:    # the same bits, one temporary fewer
                p.sub_(lr * g)
            else:
                p.copy_((p.float() - lr * g).to(p.dtype))
        return params, state

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    """Decoupled weight decay Adam; state {"m", "v": f32 like the
    parameters, "step": int32 ()}.  The bias corrections 1 - b^step are
    float32 tensor powers on the step's device, as the reference's ``b1 **
    step.astype(f32)``, so no step waits on the host."""
    def init(params):
        def zeros(_, p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        first = next(leaf_order(params))[1]
        return {"m": map_leaves(zeros, params), "v": map_leaves(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=first.device)}

    @tracing.spanned("update")
    @torch.no_grad()
    def update(grads, state, params):
        state["step"].add_(1)
        step = state["step"].float()
        bc1 = 1.0 - torch.pow(b1, step)
        bc2 = 1.0 - torch.pow(b2, step)
        for path, p in leaf_order(params):
            g = get_path(grads, path).float()
            m, v = get_path(state["m"], path), get_path(state["v"], path)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            pf = p.float()
            p.copy_((pf - lr * (upd + weight_decay * pf)).to(p.dtype))
        return params, state

    return Optimizer(init, update)


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(leaf.float().square().sum() for _, leaf in leaf_order(tree)))
