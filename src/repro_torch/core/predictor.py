"""The measurement loop's predictor: the DAG model's iteration time for
each *executable* gradient-sync policy of :mod:`repro_torch.comm.sync`.

A copy of :data:`repro.core.predictor.SYNC_POLICY_MODELS` and
:func:`repro.core.predictor.predict_sync_policy`, the bridge the paper
demonstrates in §V-D (Fig. 4): feed the measured layer-wise times into the
DAG, list-schedule it, and compare with the measurement
(:mod:`repro_torch.measure.model_vs_measured`).  The reference's
``predict`` and ``predict_workload`` need its hardware model and workload
registry, which the port does not have yet.
"""
from __future__ import annotations

from dataclasses import replace

from repro_torch.core.dag import IterationCosts
from repro_torch.core.policies import BUCKETED_25MB, CAFFE_MPI, Policy
from repro_torch.core.simulator import simulate_steady

#: Executable gradient-sync policy -> the DAG policy whose schedule models
#: it.  ``at_end`` is one fused collective after backward: a single
#: infinite bucket releases exactly when the whole backward pass has.
#: ``wfbp`` is layer-wise comm inside backward (Caffe-MPI's schedule);
#: ``bucketed`` is the DDP-default 25 MB fusion.
SYNC_POLICY_MODELS: dict[str, Policy] = {
    "at_end": Policy("at-end-fused", overlap_io=True, h2d_early=True,
                     overlap_comm=True, bucket_bytes=float("inf")),
    "wfbp": CAFFE_MPI,
    "bucketed": BUCKETED_25MB,
}


def predict_sync_policy(
    costs: IterationCosts,
    n_workers: int,
    sync_policy: str,
    comm_scale=None,
    bucket_bytes: float | None = None,
    warm_iterations: int = 8,
) -> float:
    """Model-predicted steady iteration time (seconds) for ``at_end``,
    ``wfbp`` or ``bucketed`` over measured ``costs``.

    ``comm_scale(total_bytes, naive_time) -> seconds`` prices fused buckets
    (a measured alpha-beta fit through
    :func:`repro_torch.measure.calibrate.comm_scale_from_fit`); without it
    a fused bucket costs the sum of its layers' ``t_c``.  ``bucket_bytes``
    overrides the modelled fusion threshold for ``bucketed``.
    """
    try:
        policy = SYNC_POLICY_MODELS[sync_policy]
    except KeyError:
        raise ValueError(
            f"unknown sync policy {sync_policy!r}; one of "
            f"{sorted(SYNC_POLICY_MODELS)}") from None
    if bucket_bytes is not None and sync_policy == "bucketed":
        policy = replace(policy, bucket_bytes=bucket_bytes)
    return simulate_steady(costs, n_workers, policy,
                           n_iterations=warm_iterations,
                           comm_scale=comm_scale)
