"""Predictor: turn costs (analytic model or a measured trace) into
iteration-time and speedup predictions through the DAG.

A copy of :mod:`repro.core.predictor`: :class:`Prediction`,
:func:`predict`, :func:`predict_workload` (alias :func:`predict_cnn`),
:func:`scaling_curve`, and the measurement loop's bridge
:data:`SYNC_POLICY_MODELS` / :func:`predict_sync_policy`, the bridge the
paper demonstrates in §V-D (Fig. 4): feed the measured layer-wise times
into the DAG, list-schedule it, and compare with the measurement
(:mod:`repro_torch.measure.model_vs_measured`).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core import analytical
from repro_torch.core.costmodel import comm_scale_fn
from repro_torch.core.dag import NET_CHANNEL, IterationCosts
from repro_torch.core.hardware import ClusterSpec
from repro_torch.core.policies import BUCKETED_25MB, CAFFE_MPI, Policy
from repro_torch.core.simulator import simulate_policy, simulate_steady
from repro_torch.core.workloads import resolve_workload


@dataclass(frozen=True)
class Prediction:
    policy: str
    n_workers: int
    iteration_time: float          # steady-state, from the DAG simulator
    analytical_time: float | None  # closed-form counterpart, when defined
    samples_per_sec: float
    speedup: float                 # vs 1 worker, weak scaling (Eq. 6 form)
    comm_utilization: float        # busy fraction of the collective channel


def predict(
    costs: IterationCosts,
    n_workers: int,
    policy: Policy,
    batch_per_gpu: int = 1,
    costs_1gpu: IterationCosts | None = None,
    cluster: ClusterSpec | None = None,
    warm_iterations: int = 4,
    collective: str = "ring",
) -> Prediction:
    """Steady-state iteration time for ``costs`` under ``policy``."""
    comm_scale = comm_scale_fn(cluster, n_workers, collective) \
        if cluster else None
    r = simulate_policy(costs, n_workers, policy,
                        n_iterations=warm_iterations, comm_scale=comm_scale)
    t_iter = r.steady_iteration_time()

    base = costs_1gpu or costs
    c1 = IterationCosts(t_f=base.t_f, t_b=base.t_b, t_c=[0.0] * base.num_layers,
                        t_io=base.t_io, t_h2d=base.t_h2d, t_u=base.t_u)
    t1 = simulate_steady(c1, 1, policy, n_iterations=warm_iterations)
    speedup = n_workers * t1 / t_iter if t_iter > 0 else float(n_workers)

    # None for bucketed/priority policies: their steady state has no
    # exact closed form, only the simulator result above.
    ana = analytical.closed_form(costs, policy)
    return Prediction(
        policy=policy.name,
        n_workers=n_workers,
        iteration_time=t_iter,
        analytical_time=ana,
        samples_per_sec=n_workers * batch_per_gpu / t_iter if t_iter else 0.0,
        speedup=speedup,
        comm_utilization=r.utilization(NET_CHANNEL),
    )


def predict_workload(
    workload: str,
    cluster: ClusterSpec,
    n_workers: int,
    policy: Policy,
    collective: str = "ring",
    batch_per_gpu: int | None = None,
    **cost_kw,
) -> Prediction:
    """End-to-end: registry workload name -> prediction on a cluster.

    ``workload`` is anything the registry resolves: a paper CNN
    (``"resnet50"``), a measured trace (``"trace:alexnet-k80"``,
    ``"trace:<file>"``, ``"torch:<file>"``) or an LLM config
    (``"llm:gemma3-1b"``).  ``collective`` picks the all-reduce cost model;
    ``cost_kw`` forwards to
    :meth:`~repro_torch.core.workloads.WorkloadTable.iteration_costs`.
    """
    tab = resolve_workload(workload)
    batch = batch_per_gpu or tab.batch_default
    costs = tab.iteration_costs(cluster, batch, n_workers, collective,
                                **cost_kw)
    costs_1 = tab.iteration_costs(cluster, batch, 1, collective, **cost_kw)
    return predict(costs, n_workers, policy, batch_per_gpu=batch,
                   costs_1gpu=costs_1, cluster=cluster, collective=collective)


#: Pre-registry name, kept for callers of the CNN-only era.
predict_cnn = predict_workload


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


def scaling_curve(workload: str, cluster: ClusterSpec, policy: Policy,
                  worker_counts=(1, 2, 4, 8, 16), **cost_kw) -> list[Prediction]:
    return [predict_workload(workload, cluster, n, policy, **cost_kw)
            for n in worker_counts]
