"""Closed-form iteration-time model — Eqs. (1)–(6) of the paper.

A copy of :mod:`repro.core.analytical`; the batched reductions
(:func:`non_overlapped_comm_batch`, :func:`worker_bottleneck`,
:func:`effective_sync_k`, :func:`kth_order_statistic`,
:func:`worker_bottleneck_k`) are polymorphic over NumPy and torch
(:mod:`repro_torch.core.xputil`).

These are the analytical counterparts of the DAG simulator; the
reference's property tests assert they coincide with
:func:`repro.core.simulator.simulate` on the matching topologies.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.dag import IterationCosts


def eq1_sgd_iteration(costs: IterationCosts) -> float:
    """Single-GPU mini-batch SGD: t_io + t_h2d + sum t_f + sum t_b + t_u."""
    return costs.t_io + costs.t_h2d + sum(costs.t_f) + sum(costs.t_b) + costs.t_u


def eq2_naive_ssgd(costs: IterationCosts) -> float:
    """Naive S-SGD: fully sequential io, h2d, fwd, bwd, comm, update."""
    return (costs.t_io + costs.t_h2d + sum(costs.t_f) + sum(costs.t_b)
            + sum(costs.t_c) + costs.t_u)


def eq3_io_overlap(costs: IterationCosts) -> float:
    """Overlapping I/O with computing: max(t_io + t_h2d, t_f + t_b + t_c).

    The paper's Eq. (3) omits ``t_u``; in steady state the update
    belongs to the GPU pipeline stage, so it joins the compute branch
    of the max (this is what the DAG simulator produces exactly).
    """
    return max(costs.t_io + costs.t_h2d,
               sum(costs.t_f) + sum(costs.t_b) + sum(costs.t_c) + costs.t_u)


def non_overlapped_comm(t_b: Sequence[float], t_c: Sequence[float]) -> float:
    """``t_c^no`` — the residual communication that WFBP cannot hide.

    Greedy WFBP schedule (paper §IV-C): the all-reduce of layer ``l``
    may start once the backward of layer ``l`` has finished, and the
    collective channel serializes.  Backward runs layer L..1.  The
    returned value satisfies Eq. (5):

        t_iter = max(t_io + t_h2d, t_f + t_b + t_c^no)
    """
    L = len(t_b)
    if L != len(t_c):
        raise ValueError("length mismatch")
    bwd_finish = 0.0
    comm_finish = 0.0
    for l in range(L - 1, -1, -1):      # layer L first
        bwd_finish += t_b[l]
        if t_c[l] > 0:
            comm_finish = max(comm_finish, bwd_finish) + t_c[l]
    total_b = sum(t_b)
    return max(comm_finish - total_b, 0.0)


def non_overlapped_comm_batch(t_b: np.ndarray, t_c: np.ndarray) -> np.ndarray:
    """Vectorized ``t_c^no`` over ``(scenario, layer)`` matrices — the
    prefix-max formulation of :func:`non_overlapped_comm`.

    Unrolling the greedy WFBP recurrence
    ``comm_finish = max(comm_finish, bwd_finish_l) + t_c_l`` (layers
    visited L..1, zero-comm layers skipped) gives the closed form

        comm_finish = max over layers l with t_c_l > 0 of
                      (bwd_finish_l + sum of t_c over layers <= l)

    i.e. a backward-time suffix sum plus a comm prefix sum, reduced
    with one max — three cumulative-sum/max passes over the matrix, no
    per-scenario Python.  Zero-padded layers (``t_b = t_c = 0``) drop
    out of both sums and are masked from the max, which is what lets
    the batched evaluator share one padded matrix across workloads of
    different depths.

    ``t_b`` / ``t_c`` are ``(..., L)`` in forward layer order (index 0
    = layer 1), matching :class:`~repro_torch.core.dag.IterationCosts`, with
    the layer axis last — ``(S, L)`` matrices on the batched NumPy
    path, or torch tensors of the same shapes (the function is
    dtype-polymorphic over NumPy and torch).  Returns the ``(...,)`` residual,
    elementwise identical (<= 1e-9 relative, property-tested) to the
    scalar loop.
    """
    from repro_torch.core.xputil import array_namespace, max_or_zero

    xp = array_namespace(t_b, t_c)
    t_b = xp.asarray(t_b, dtype=xp.float64)
    t_c = xp.asarray(t_c, dtype=xp.float64)
    if t_b.shape != t_c.shape:
        raise ValueError("length mismatch")
    # All passes run on the forward-order contiguous matrices:
    # bwd_finish at layer l is the *suffix* sum of t_b (backward has
    # reached l), the comm issued by then is the *prefix* sum of t_c
    # (layers >= l were all enqueued first), and mask-multiplication
    # (not np.where) zeroes the no-comm candidates.
    prefix_b = xp.cumsum(t_b, axis=-1)
    total_b = prefix_b[..., -1]
    suffix_b = (total_b[..., None] - prefix_b) + t_b     # inclusive suffix
    prefix_c = xp.cumsum(t_c, axis=-1)
    cand = (suffix_b + prefix_c) * (t_c > 0)
    comm_finish = max_or_zero(cand, -1)
    return xp.maximum(comm_finish - total_b, 0.0)


def worker_bottleneck(inv_speed, bw_mult, lat_mult, axis: int = -1):
    """Slowest-worker reduction over the per-worker axis: the
    synchronous steady state is gated by the slowest participant, so a
    heterogeneous scenario collapses to the homogeneous closed forms
    evaluated at ``tmul = max_w inv_speed``, ``bwmul = min_w bw_mult``,
    ``latmul = max_w lat_mult``.

    Exact, not an approximation: per-worker multipliers are constant
    across layers, so the same worker attains the per-layer max at
    every layer and the per-worker DAG reproduces the reduced closed
    form (property-tested against the event-driven simulator ≤1e-6).

    Accepts the zero/``+inf``-padded ``(..., Wmax)`` worker tables of
    :func:`repro_torch.core.het.worker_table_rows` — the pads are neutral for
    these reductions — and is dtype-polymorphic over NumPy and
    torch (the batched kernels of both backends reduce the same
    padded tables).  A constant vector reduces to its value bit-exactly
    (max/min never round), which is what keeps all-ones profiles
    bit-identical to the scalar path.
    """
    from repro_torch.core.xputil import array_namespace

    xp = array_namespace(inv_speed, bw_mult, lat_mult)
    return (xp.max(inv_speed, axis=axis),
            xp.min(bw_mult, axis=axis),
            xp.max(lat_mult, axis=axis))


def effective_sync_k(sync_k, n_workers):
    """The K actually waited for: ``sync_k`` clamped to ``[1, n]``,
    with the full-sync sentinels (``None`` / ``0``) mapping to ``n``.
    Clamping (rather than rejecting ``K > n``) keeps grid-axis
    validation separable from the worker-count axis — the same design
    rule as the het profiles' proportional slot stretching.  Accepts
    scalars or arrays (vectorized over rows)."""
    from repro_torch.core.xputil import array_namespace

    if sync_k is None:
        return n_workers
    xp = array_namespace(sync_k, n_workers)
    k = xp.asarray(sync_k)
    n = xp.asarray(n_workers)
    return xp.where(k <= 0, n, xp.clip(k, 1, n))


def kth_order_statistic(values, n, k):
    """The ``k``-th smallest of the ``n`` live entries in each
    zero-padded ``(..., Wmax)`` row of ``values`` (live entries are
    strictly positive, pads are ``0`` — the
    :func:`repro_torch.core.het.worker_table_rows` convention).

    ``k = n`` returns exactly the row max (the slowest-worker
    reduction, bit-identical — a sort never rounds); ``k = 1`` the live
    min.  Sorting descending puts the pads *last*, so the ``k``-th
    smallest live value sits at index ``n - k`` regardless of padding.
    Dtype-polymorphic: both namespaces sort the whole row (``np.sort`` /
    ``torch.sort``) and take the descending order.  ``n`` and ``k``
    broadcast over the leading axes; ``k`` must already be clamped to
    ``[1, n]`` (:func:`effective_sync_k`)."""
    from repro_torch.core.xputil import array_namespace, astype

    xp = array_namespace(values, n, k)
    values = xp.asarray(values, dtype=xp.float64)
    wmax = values.shape[-1]
    n = xp.asarray(n)
    k = xp.asarray(k)
    desc = -xp.sort(-values, axis=-1)
    idx = astype(xp.clip(n - k, 0, wmax - 1), xp.int64)
    idx = xp.broadcast_to(idx, values.shape[:-1])
    return xp.take_along_axis(desc, idx[..., None], axis=-1)[..., 0]


def worker_bottleneck_k(inv_speed, bw_mult, lat_mult, n, sync_k, axis: int = -1):
    """K-of-N generalization of :func:`worker_bottleneck`: the
    synchronous update fires once the ``K``-th fastest gradient is in,
    so the compute multiplier is the ``K``-th *order statistic* of the
    per-worker ``inv_speed`` (not the max), while the link multipliers
    stay the full min/max — all ``N`` workers keep their place in the
    collective and receive the broadcast update; the threshold only
    stops the barrier from waiting for gradients beyond the ``K``-th.

    Exactness argument unchanged from :func:`worker_bottleneck`:
    per-worker multipliers are constant across layers, so the worker
    ranked ``K``-th is ranked ``K``-th at every layer, and the K-of-N
    DAG steady state equals the homogeneous closed form at
    ``tmul = kth_smallest_w(inv_speed)`` (property-tested ≤1e-6 against
    the event-driven simulator).  ``sync_k`` may be a scalar or a
    per-row array; full-sync sentinels (``None``/``0``) and ``K >= n``
    reproduce :func:`worker_bottleneck` bit-identically."""
    from repro_torch.core.xputil import array_namespace

    if axis != -1:
        raise ValueError("worker_bottleneck_k reduces the last axis only")
    xp = array_namespace(inv_speed, bw_mult, lat_mult)
    keff = effective_sync_k(sync_k, n)
    return (kth_order_statistic(inv_speed, n, keff),
            xp.min(bw_mult, axis=-1),
            xp.max(lat_mult, axis=-1))


def eq5_wfbp(costs: IterationCosts) -> float:
    """WFBP: max(t_io + t_h2d, t_f + t_b + t_c^no + t_u)."""
    tc_no = non_overlapped_comm(costs.t_b, costs.t_c)
    return max(costs.t_io + costs.t_h2d,
               sum(costs.t_f) + sum(costs.t_b) + tc_no + costs.t_u)


def eq3_late_h2d(costs: IterationCosts) -> float:
    """CNTK pipeline: I/O overlapped but the H2D copy waits for the
    previous model update (no spare device buffer), so ``t_h2d`` joins
    the GPU-side chain:

        t_iter = max(t_io + t_h2d, t_h2d + t_f + t_b + t_c + t_u)

    This is the late-H2D variant of Eq. (3); the DAG simulator
    reproduces it exactly (property-tested).
    """
    return max(costs.t_io + costs.t_h2d,
               costs.t_h2d + sum(costs.t_f) + sum(costs.t_b)
               + sum(costs.t_c) + costs.t_u)


def eq5_late_h2d(costs: IterationCosts) -> float:
    """MXNet/TensorFlow pipeline: WFBP comm overlap, but late H2D —
    the late-H2D variant of Eq. (5):

        t_iter = max(t_io + t_h2d, t_h2d + t_f + t_b + t_c^no + t_u)
    """
    tc_no = non_overlapped_comm(costs.t_b, costs.t_c)
    return max(costs.t_io + costs.t_h2d,
               costs.t_h2d + sum(costs.t_f) + sum(costs.t_b) + tc_no + costs.t_u)


def eq6_speedup(costs_1gpu: IterationCosts, costs_n: IterationCosts,
                n_gpus: int) -> float:
    """Weak-scaling speedup of N_g GPUs over one GPU (Eq. 6).

    ``costs_1gpu`` carries the single-GPU I/O time ``t_io_1`` and zero
    comm; ``costs_n`` carries the per-layer comm of the N_g-GPU run and
    the (possibly larger) I/O time ``t_io_Ng``.
    """
    t1 = max(costs_1gpu.t_io + costs_1gpu.t_h2d,
             sum(costs_1gpu.t_f) + sum(costs_1gpu.t_b))
    tc_no = non_overlapped_comm(costs_n.t_b, costs_n.t_c)
    tn = max(costs_n.t_io + costs_n.t_h2d,
             sum(costs_n.t_f) + sum(costs_n.t_b) + tc_no)
    return n_gpus * t1 / tn if tn > 0 else float(n_gpus)


def has_closed_form(policy) -> bool:
    """True when ``policy``'s steady state has an exact *per-layer*
    closed form — Eqs. (2)/(3)/(5) or a late-H2D variant.

    Bucket fusion and priority comm fall outside these equations:
    bucket boundaries and net-channel reordering depend on the schedule
    itself.  Their steady state *is* still exactly expressible — as the
    bucket-timeline form (:func:`has_timeline_form`,
    :mod:`repro_torch.core.bucketsim`) — just not by the per-layer equations
    this predicate guards.  The single shared predicate for
    :func:`closed_form` and the sweep engine's fast-path routing.
    """
    if policy.bucket_bytes or policy.priority_comm:
        return False
    if not policy.overlap_io and (policy.overlap_comm or policy.h2d_early):
        return False           # combination not studied; simulate it
    return True


def has_timeline_form(policy) -> bool:
    """True when ``policy``'s steady state is exactly expressible by
    the **bucket-timeline** form (:mod:`repro_torch.core.bucketsim`): a
    schedule-dependent comm policy (bucket fusion and/or priority
    scheduling) whose pipeline flags are among the studied
    combinations.

    The net channel is a single work-conserving resource, so its
    iteration makespan is order-independent — bucketed-FIFO and
    priority schedules share one closed residual (property-tested
    against the event-driven simulator, which remains the agreement
    oracle and the path ``force_simulator=True`` pins).  Policies that
    are neither closed-form nor timeline-form (unstudied pipeline
    combinations) still fall back to the simulator.
    """
    if not (policy.bucket_bytes or policy.priority_comm):
        return False           # per-layer exact policy: closed form
    if not policy.overlap_io and (policy.overlap_comm or policy.h2d_early):
        return False           # combination not studied; simulate it
    return True


def closed_form(costs: IterationCosts, policy) -> float | None:
    """Exact closed-form steady-state iteration time for ``policy``
    (a :class:`repro_torch.core.policies.Policy`), or ``None`` when no exact
    closed form exists and the event-driven simulator must be used.

    Exactness (verified by the property tests in
    ``tests/test_dag_model.py`` and ``tests/test_sweep.py``):

    * no I/O overlap, no comm overlap  -> Eq. (2)
    * I/O overlap, early H2D           -> Eq. (3) / Eq. (5) with WFBP
    * I/O overlap, late H2D            -> the late-H2D variants above
    * bucket fusion or priority comm   -> inexact (``None``), see
      :func:`has_closed_form`.
    """
    if costs.num_layers == 0 or not has_closed_form(policy):
        return None
    if not policy.overlap_io:
        return eq2_naive_ssgd(costs)
    if policy.overlap_comm:
        return eq5_wfbp(costs) if policy.h2d_early else eq5_late_h2d(costs)
    return eq3_io_overlap(costs) if policy.h2d_early else eq3_late_h2d(costs)


def iteration_time(costs: IterationCosts, policy_name: str) -> float:
    """Dispatch the closed form matching a named policy.

    Raises ``ValueError`` for policies without an exact closed form
    (bucketed / priority) — use the DAG simulator for those.
    """
    from repro_torch.core.policies import get_policy

    p = get_policy(policy_name)
    t = closed_form(costs, p)
    if t is None:
        raise ValueError(
            f"policy {policy_name!r} has no exact closed form; "
            "use repro_torch.core.simulator")
    return t
