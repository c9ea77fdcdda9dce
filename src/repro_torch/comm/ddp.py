"""Explicit data-parallel S-SGD train step (the paper's Algorithm 1).

Counterpart of :func:`repro.comm.ddp.make_ddp_train_step`: parameters
replicated on every rank of the process group, each rank holding its
shard of the batch, gradients synchronized by the policy-selected
schedule of :mod:`repro_torch.comm.sync`.
"""
from __future__ import annotations

from repro_torch import tracing
from repro_torch.comm import sync as S
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models.common import ModelConfig
from repro_torch.optim.sgd import Optimizer, global_norm


def make_ddp_train_step(cfg: ModelConfig, optimizer: Optimizer, comm: S.Comm | None,
                        sync_policy: str = "wfbp",
                        bucket_bytes: float = S.DEFAULT_BUCKET_BYTES):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``batch`` holds this rank's ``tokens`` and ``labels``;
    ``comm`` is None for a single process (``sync_policy`` "none").  The
    parameters and optimizer state are updated in place (see
    :mod:`repro_torch.optim.sgd`).  Each of the two metric means is one
    4-byte f32 all-reduce, as in the reference.  Under
    :func:`repro_torch.tracing.record` the step is a ``step`` span of
    ``fwd``, ``bwd`` and ``update``."""
    if sync_policy not in S.SYNC_POLICIES:
        raise ValueError(f"unknown sync policy {sync_policy!r}")
    if comm is None and sync_policy != "none":
        raise ValueError(f"sync policy {sync_policy!r} needs a process group")

    @tracing.spanned("step")
    def step(params, opt_state, batch):
        hook = S.WfbpHook(comm) if sync_policy == "wfbp" else None
        total, metrics, grads = loss_and_grads(cfg, params, batch["tokens"], batch["labels"],
                                               param_hook=hook)
        if hook is not None:
            hook.finish(grads)
        grads = S.sync_gradients(grads, sync_policy, comm, bucket_bytes)
        loss = metrics["loss"].detach().float()
        total = total.detach().float()
        if comm is not None:
            total = comm.mean(total)
            loss = comm.mean(loss)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "total_loss": total,
                                   "grad_norm": global_norm(grads)}

    return step
