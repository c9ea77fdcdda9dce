"""SGD with momentum — the paper's algorithm — and ``global_norm``.

Counterpart of :mod:`repro.optim.sgd` lines 17-52 and 87-89, with the same
optax-style interface: ``opt.init(params) -> state`` and
``opt.update(grads, state, params) -> (params, state)``.  Momentum and the
update math are float32 and the result is cast back to the parameter
dtype, as in the reference.  Unlike the reference, ``update`` writes the
new parameters and momentum in place (at full width a functional copy
would double the memory of both) and returns the same dicts.  ``adamw``
waits for the training-launcher slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

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
            p.copy_((p.float() - lr * g).to(p.dtype))
        return params, state

    return Optimizer(init, update)


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(leaf.float().square().sum() for _, leaf in leaf_order(tree)))
