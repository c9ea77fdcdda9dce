"""Scenario-axis batched fast path: the whole sweep as matrices.

A copy of :mod:`repro.core.batched`, the NumPy engine: the reference
arithmetic in the reference order, so its columns equal the original's
bit for bit.  Its twin on the card, :mod:`repro_torch.core.batched_torch`,
reuses its structure (axis tables, code vectors, the unique compute rows,
the straggler Monte Carlo pass).

The per-scenario fast path (:func:`repro_torch.core.sweep._fast_eval`) is
vectorized over the *layer* dimension only — every scenario still pays
a Python round-trip through ``resolve_workload -> iteration_costs ->
closed_form``, which caps the engine at roughly 10k scenarios/s.  This
module vectorizes the *scenario* axis too, in two tiers:

* **Kernel grid**: every per-layer cost (``t_f``/``t_b``/``t_c``), the
  pipeline terms and the WFBP residual depend only on ``(workload,
  cluster x interconnect, n_workers, collective, batch)`` — *not* on
  the overlap policy.  The unique points of that reduced product are
  evaluated as ``(K, L)`` matrices built in one shot from array-valued
  collective models (:mod:`repro_torch.core.hardware`) over per-point
  ``(n_workers, bandwidth, latency)`` vectors, with the prefix-max
  formulation of the WFBP residual
  (:func:`repro_torch.core.analytical.non_overlapped_comm_batch`) reducing
  them to ``(K,)`` terms — pure NumPy over both axes, no per-scenario
  Python.  Workloads of different depths share one zero-padded
  ``(…, L_max)`` table: a padded layer has ``t_f = t_b = t_c =
  grad_bytes = 0``, contributes nothing to any sum, and is masked out
  of the prefix-max.
* **Policy select**: Eqs. (2)/(3)/(5) and their late-H2D variants are
  ``max``/``+`` combinations of those ``(K,)`` terms; each scenario
  gathers its kernel point and selects its policy's equation — cheap
  ``(S,)`` vector ops, so adding policies to a grid costs almost
  nothing.

Schedule-dependent policies (bucket fusion, priority comm) ride the
same two tiers: the kernel additionally reduces padded ``(S, B)``
bucket matrices (structure from :mod:`repro_torch.core.bucketsim`, fused
payloads costed through the same collective dispatch as the per-layer
``t_c``) to one timeline-residual column per distinct bucket size, and
the policy select substitutes that residual for the WFBP term — see
:func:`repro_torch.core.analytical.has_timeline_form` for why this is exact.

Correctness contract: every closed-form row agrees with the
per-scenario reference implementation ``_fast_eval`` to <= 1e-9
relative, and every timeline row with the event-driven
``simulate_steady`` oracle to <= 1e-6 (property-tested on the default,
mixed and frontier grids).  This module is the throughput engine
:func:`repro_torch.core.sweep.sweep` routes every batched-eligible scenario
through.

:func:`grid_evaluator` memoizes the prepared *structure* of a grid
(axis tables, code vectors, label lists) keyed by grid value and
resolved table identity — numeric results are recomputed on every
:meth:`GridEvaluator.run`, never cached.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.core import analytical, bucketsim
from repro_torch.core import het as het_mod
from repro_torch.core.hardware import (CLUSTERS, apply_interconnect_preset,
                                 hierarchical_allreduce_coeffs,
                                 ring_allreduce_coeffs,
                                 tree_allreduce_coeffs)
from repro_torch.core.policies import Policy, get_policy
from repro_torch.core.resulttable import METHOD_LABELS, rows_from_table
from repro_torch.core.scenarios import (Scenario, ScenarioGrid,
                                  normalize_interconnect,
                                  normalize_sync_k)
from repro_torch.core.workloads import WorkloadTable, resolve_workload

_COLLECTIVE_CODE = {"ring": 0, "tree": 1, "hierarchical": 2}

#: Kernel points evaluated per ``(K, L)`` matrix allocation — bounds
#: transient memory on huge grids without measurably hurting speed.
KERNEL_CHUNK = 8192


# ----------------------------------------------------------------------
# Axis tables: everything a code vector indexes into.
# ----------------------------------------------------------------------
@dataclass
class _WorkloadAxis:
    """Unique workloads of the batch, padded to a shared layer count.

    Analytic tables populate ``flops``; measured ones populate
    ``tf_meas``/``tb_meas`` (the other family's rows are zero, so the
    combined expression ``flops*batch/rate + tf_meas*scale`` is exact
    for both — adding literal 0.0 is FP-identity).
    """

    names: list[str]                  # row-label spelling, as given
    flops: np.ndarray                 # (W, Lmax) per-sample fwd flops
    tf_meas: np.ndarray               # (W, Lmax) measured fwd s @ batch_default
    tb_meas: np.ndarray               # (W, Lmax) measured bwd s @ batch_default
    grad_bytes: np.ndarray            # (W, Lmax) all-reduce payload
    bwd_ratio: np.ndarray             # (W,)
    batch_default: np.ndarray         # (W,) float64
    bytes_per_sample: np.ndarray      # (W,)
    param_bytes: np.ndarray           # (W,)
    t_io_meas: np.ndarray             # (W,) measured input-pipeline s (0 if analytic)
    has_meas_io: np.ndarray           # (W,) bool
    batch_locked: np.ndarray          # (W,) bool
    table_names: list[str]            # canonical names, for error messages
    any_measured: bool                # any table with measured t_f/t_b
    any_meas_io: bool                 # any table with measured t_io


def _workload_axis(names: Sequence[str]) -> _WorkloadAxis:
    """Resolve + pad the unique workloads of a batch."""
    tables: list[WorkloadTable] = [resolve_workload(n) for n in names]
    lmax = max((t.num_layers for t in tables), default=1)
    W = len(tables)
    flops = np.zeros((W, lmax))
    tf_meas = np.zeros((W, lmax))
    tb_meas = np.zeros((W, lmax))
    grad = np.zeros((W, lmax))
    for i, t in enumerate(tables):
        L = t.num_layers
        grad[i, :L] = t.grad_bytes
        if t.is_measured:
            tf_meas[i, :L] = t.t_f
            tb_meas[i, :L] = t.t_b
        else:
            flops[i, :L] = t.flops_fwd
    return _WorkloadAxis(
        names=list(names),
        flops=flops, tf_meas=tf_meas, tb_meas=tb_meas, grad_bytes=grad,
        bwd_ratio=np.array([t.bwd_fwd_ratio for t in tables]),
        batch_default=np.array([t.batch_default for t in tables],
                               dtype=np.float64),
        bytes_per_sample=np.array([t.bytes_per_sample for t in tables]),
        param_bytes=np.array([t.param_bytes for t in tables]),
        t_io_meas=np.array([t.t_io_measured or 0.0 for t in tables]),
        has_meas_io=np.array([t.t_io_measured is not None for t in tables],
                             dtype=bool),
        batch_locked=np.array([t.batch_locked for t in tables], dtype=bool),
        table_names=[t.name for t in tables],
        # distinct flags: a trace can carry measured t_f/t_b without a
        # 'data' layer (no measured t_io) — gating the compute-time
        # terms on measured *I/O* would silently zero its layers
        any_measured=any(t.is_measured for t in tables),
        any_meas_io=any(t.t_io_measured is not None for t in tables))


def _check_batch_locked(wax: _WorkloadAxis, widx: np.ndarray,
                        batch: np.ndarray) -> None:
    """Exactly the guard
    :meth:`~repro_torch.core.workloads.WorkloadTable.iteration_costs` applies
    per scenario: a batch override on a trace without a recorded batch
    is an error (its measured times cannot be rescaled)."""
    bad = wax.batch_locked[widx] & (batch > 0) \
        & (batch != wax.batch_default[widx])
    if bool(bad.any()):
        i = int(np.argmax(bad))
        raise ValueError(
            f"workload {wax.table_names[int(widx[i])]!r} has no recorded "
            f"batch size (no '# batch:' header in the trace), so its "
            f"measured times cannot be rescaled to batch_per_gpu="
            f"{int(batch[i])}; leave batch_per_gpu unset")


@dataclass
class _ClusterAxis:
    """Unique ``(cluster, interconnect)`` pairs, resolved once.

    Node sizing (``with_workers``) never changes any of these
    parameters, so the pair — not the worker count — is the right
    resolution key.
    """

    intra_bw: np.ndarray
    intra_lat: np.ndarray
    inter_bw: np.ndarray
    inter_lat: np.ndarray
    gpn: np.ndarray                   # gpus_per_node, int64
    disk_lat: np.ndarray
    disk_bw: np.ndarray
    h2d_lat: np.ndarray
    h2d_bw: np.ndarray
    rate: np.ndarray                  # achieved flop/s
    hbm_bw: np.ndarray


def _cluster_axis(pairs: Sequence[tuple[str, str | None]]) -> _ClusterAxis:
    specs = [apply_interconnect_preset(CLUSTERS[c], ic) for c, ic in pairs]
    return _ClusterAxis(
        intra_bw=np.array([c.intra.effective_bandwidth for c in specs]),
        intra_lat=np.array([c.intra.latency for c in specs]),
        inter_bw=np.array([c.inter.effective_bandwidth for c in specs]),
        inter_lat=np.array([c.inter.latency for c in specs]),
        gpn=np.array([c.gpus_per_node for c in specs], dtype=np.int64),
        disk_lat=np.array([c.disk.latency for c in specs]),
        disk_bw=np.array([c.disk.effective_bandwidth for c in specs]),
        h2d_lat=np.array([c.h2d.latency for c in specs]),
        h2d_bw=np.array([c.h2d.effective_bandwidth for c in specs]),
        rate=np.array([c.device.peak_flops * c.device.compute_efficiency
                       for c in specs]),
        hbm_bw=np.array([c.device.hbm_bandwidth for c in specs]))


@dataclass
class _PolicyAxis:
    names: list[str]
    overlap_io: np.ndarray            # (P,) bool
    overlap_comm: np.ndarray
    h2d_early: np.ndarray
    has_fast: np.ndarray              # (P,) exact per-layer closed form
    has_tl: np.ndarray                # (P,) exact bucket-timeline form
    tier: np.ndarray                  # (P,) METHOD_LABELS index
    tl_spec: np.ndarray               # (P,) index into tl_specs, -1 = none
    #: Unique ``(bucket_bytes, overlap_comm)`` pairs the kernel must
    #: compute a timeline-residual column for.  Priority-only policies
    #: (no buckets) need no column: order-independence makes their
    #: residual the per-layer WFBP term ``tc_no`` already on hand.
    tl_specs: list[tuple[float, bool]]


def _policy_axis(names: Sequence[str]) -> _PolicyAxis:
    pols: list[Policy] = [get_policy(n) for n in names]
    specs: dict[tuple[float, bool], int] = {}
    tl_spec = np.full(len(pols), -1, dtype=np.int64)
    for i, p in enumerate(pols):
        if analytical.has_timeline_form(p) and p.bucket_bytes:
            key = (float(p.bucket_bytes), bool(p.overlap_comm))
            tl_spec[i] = specs.setdefault(key, len(specs))
    has_fast = np.array([analytical.has_closed_form(p) for p in pols],
                        dtype=bool)
    has_tl = np.array([analytical.has_timeline_form(p) for p in pols],
                      dtype=bool)
    return _PolicyAxis(
        names=list(names),
        overlap_io=np.array([p.overlap_io for p in pols], dtype=bool),
        overlap_comm=np.array([p.overlap_comm for p in pols], dtype=bool),
        h2d_early=np.array([p.h2d_early for p in pols], dtype=bool),
        has_fast=has_fast,
        has_tl=has_tl,
        tier=np.where(has_fast, 0, np.where(has_tl, 1, 2)).astype(np.int64),
        tl_spec=tl_spec,
        tl_specs=list(specs))


# ----------------------------------------------------------------------
# Tier 1: the affine kernel — policy-independent cost terms.
# ----------------------------------------------------------------------
def _collective_coeffs(cax: _ClusterAxis, cidx: np.ndarray,
                       coll: np.ndarray, n: np.ndarray,
                       bwmul: np.ndarray | None = None,
                       latmul: np.ndarray | None = None,
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Per-point affine collective coefficients ``(per_byte,
    per_message)``: every collective model is affine in the payload for
    fixed ``(n, links)`` (see :mod:`repro_torch.core.hardware`), and each
    algorithm's coefficients are evaluated only on its own points (the
    collective axis partitions the kernel grid).

    ``bwmul``/``latmul`` are per-point slowest-worker link multipliers
    (per-worker vectors already reduced by
    :func:`repro_torch.core.analytical.worker_bottleneck`): a heterogeneous
    collective is gated by its slowest link, so both the intra- and
    inter-node parameters are derated before the algorithm dispatch
    (hierarchical scales both levels).  ``None`` (or all-ones — FP
    multiply by 1.0 is exact) leaves the homogeneous path bit-identical.
    """
    n_f = n.astype(np.float64)
    intra_bw, intra_lat = cax.intra_bw[cidx], cax.intra_lat[cidx]
    inter_bw, inter_lat = cax.inter_bw[cidx], cax.inter_lat[cidx]
    if bwmul is not None:
        intra_bw = intra_bw * bwmul
        inter_bw = inter_bw * bwmul
    if latmul is not None:
        intra_lat = intra_lat * latmul
        inter_lat = inter_lat * latmul
    use_intra = n <= cax.gpn[cidx]
    link_bw = np.where(use_intra, intra_bw, inter_bw)
    link_lat = np.where(use_intra, intra_lat, inter_lat)
    codes_present = np.unique(coll)
    if len(codes_present) == 1:
        sels: list = [slice(None)]
    else:
        sels = [np.nonzero(coll == code)[0] for code in codes_present]
    per_byte = np.empty(len(cidx))
    per_message = np.empty(len(cidx))
    for code, sel in zip(codes_present, sels):
        if code == 0:
            a, b = ring_allreduce_coeffs(n_f[sel], link_bw[sel],
                                         link_lat[sel])
        elif code == 1:
            a, b = tree_allreduce_coeffs(n[sel], link_bw[sel],
                                         link_lat[sel])
        else:
            a, b = hierarchical_allreduce_coeffs(
                n[sel], cax.gpn[cidx[sel]], intra_bw[sel], intra_lat[sel],
                inter_bw[sel], inter_lat[sel])
        per_byte[sel], per_message[sel] = a, b
    return per_byte, per_message


def _compute_row_map(wax: _WorkloadAxis, cax: _ClusterAxis,
                     widx: np.ndarray, cidx: np.ndarray,
                     batch: np.ndarray,
                     tmul: np.ndarray | None = None):
    """``(uw, uc, ubatch, ut, uk)``: the unique *compute rows* of a
    point set and the point -> row map.  ``t_f``/``t_b`` (and
    everything derived from them: prefix/suffix sums, ``comp``) depend
    only on ``(workload, device rate, batch)`` — on a product grid that
    is a tiny set (workloads x devices, not x interconnects x workers x
    collectives), so the layer-axis matrices are built on ``U`` rows
    and gathered per point instead of being recomputed ``K`` times.

    ``tmul`` (per-point slowest-worker compute multipliers) joins the
    unique key — it must, because it scales the *measured* time tables
    too, which bypass the device rate — and comes back as the
    per-unique-row ``ut`` column (``None`` when not given).  A constant
    ``tmul`` contributes one key level and leaves the row set (and the
    homogeneous path) unchanged."""
    urate, rinv = np.unique(cax.rate[cidx], return_inverse=True)
    ubv, binv = np.unique(batch, return_inverse=True)
    key = (widx * len(ubv) + binv) * len(urate) + rinv
    if tmul is not None:
        utm, tinv = np.unique(tmul, return_inverse=True)
        key = key * len(utm) + tinv
    _, rep, uk = np.unique(key, return_index=True, return_inverse=True)
    ut = None if tmul is None else tmul[rep]
    return widx[rep], cidx[rep], batch[rep], ut, uk


def _kernel_cols(wax: _WorkloadAxis, cax: _ClusterAxis,
                 widx: np.ndarray, cidx: np.ndarray, coll: np.ndarray,
                 n: np.ndarray, batch: np.ndarray,
                 tl_specs: Sequence[tuple[float, bool]] = (),
                 chunk: int = KERNEL_CHUNK,
                 tmul: np.ndarray | None = None,
                 bwmul: np.ndarray | None = None,
                 latmul: np.ndarray | None = None) -> dict[str, np.ndarray]:
    """Policy-independent terms for every kernel point, reduced over
    the layer axis: ``(K,)`` vectors of ``io_h2d``, ``t_h2d``, ``comp``
    (= sum t_f + sum t_b), ``sum_c``, ``tc_no``, ``t_u``, plus the
    resolved ``n_f``/``batch_f``.

    The evaluation is **cumsum-free over the point axis**: per-point
    collective costs are affine in the payload (``per_byte * M +
    per_message``, :func:`_collective_coeffs`), so every per-layer
    prefix sum collapses to the workload-level cumulative tables
    ``cumgrad``/``cumcount`` scaled by two per-point scalars, and
    ``sum_c`` to ``per_byte * sum(grad) + per_message * n_comm``.  The
    backward-time tables themselves are built once per unique
    ``(workload, rate, batch)`` *compute row* (:func:`_compute_row_map`
    — a handful of rows even on frontier-sized grids) and gathered per
    point.  The surviving ``(k, L)`` work is a fused multiply-add +
    masked max for the WFBP residual, built ``chunk`` points at a time
    so huge grids stay in bounded memory.

    ``tl_specs`` (from :attr:`_PolicyAxis.tl_specs`) adds one
    bucket-timeline residual column ``tl<i>`` per unique
    ``(bucket_bytes, overlap_comm)`` pair, through the same affine
    collapse: bucket structure from the shared
    :func:`repro_torch.core.bucketsim.bucket_table` boundaries, duration
    suffix sums from :func:`repro_torch.core.bucketsim.suffix_tables` (so
    fused buckets amortize latency exactly as
    ``repro_torch.core.costmodel.comm_scale_fn`` does), release times
    gathered from the per-row backward suffix — the exact
    :func:`repro_torch.core.bucketsim.timeline_residual` makespan, never
    materializing a per-point duration matrix.

    ``tmul``/``bwmul``/``latmul`` (all ``(K,)`` or ``None``) are the
    slowest-worker bottleneck multipliers of the heterogeneity engine —
    per-worker vectors already reduced by
    :func:`repro_torch.core.analytical.worker_bottleneck` (and, on the Monte
    Carlo straggler path, already folded with each draw's jitter):
    ``tmul`` scales every compute-time term (analytic *and* measured —
    it joins the unique-row key via :func:`_compute_row_map`), while
    ``bwmul``/``latmul`` derate the collective links
    (:func:`_collective_coeffs`).  ``t_io``/``t_h2d`` stay homogeneous
    (their channels are per-worker and identical) and ``t_u`` is
    HBM-bandwidth-bound, not compute-rate-bound, so neither is scaled.
    All-ones multipliers are bit-identity (IEEE ``x * 1.0 == x``).
    """
    K = len(widx)
    # Per-workload layer tables: inclusive payload/count prefix sums
    # (forward order) for the affine WFBP residual, plus the bucket
    # structure + suffix tables per timeline spec — all O(W x L), built
    # once per call, gathered per chunk.
    grad = wax.grad_bytes
    comm_mask = (grad > 0).astype(np.float64)
    cumgrad = np.cumsum(grad, axis=1)
    cumcount = np.cumsum(comm_mask, axis=1)
    gradsum, ncomm = cumgrad[:, -1], cumcount[:, -1]
    btables = []
    for bb, _ in tl_specs:
        bt = bucketsim.bucket_table(wax.grad_bytes, bb)
        btables.append((bt,) + bucketsim.suffix_tables(bt))
    out = {name: np.empty(K) for name in
           ("io_h2d", "t_h2d", "comp", "sum_c", "tc_no", "t_u",
            "n_f", "batch_f")}
    for i in range(len(tl_specs)):
        out[f"tl{i}"] = np.empty(K)
    for lo in range(0, K, chunk):
        sl = slice(lo, lo + chunk)
        w, c = widx[sl], cidx[sl]
        nn, cl = n[sl], coll[sl]
        batch_f = np.where(batch[sl] > 0, batch[sl],
                           wax.batch_default[w]).astype(np.float64)
        n_f = nn.astype(np.float64)

        # compute costs: (U, L) on the unique compute rows only
        uw, uc, ub, ut, uk = _compute_row_map(
            wax, cax, w, c, batch[sl],
            None if tmul is None else tmul[sl])
        ubatch_f = np.where(ub > 0, ub,
                            wax.batch_default[uw]).astype(np.float64)
        tfa = wax.flops[uw] * ubatch_f[:, None] / cax.rate[uc][:, None]
        t_f = tfa
        t_b = wax.bwd_ratio[uw][:, None] * tfa
        if wax.any_measured:          # adding literal 0.0 rows is exact,
            scale = (ubatch_f / wax.batch_default[uw])[:, None]
            t_f = t_f + wax.tf_meas[uw] * scale    # but skip it when the
            t_b = t_b + wax.tb_meas[uw] * scale    # batch has no traces
        if ut is not None:            # slowest-worker compute multiplier
            t_f = t_f * ut[:, None]
            t_b = t_b * ut[:, None]
        prefix_b = np.cumsum(t_b, axis=1)
        total_b_u = prefix_b[:, -1]
        suffix_b_u = (total_b_u[:, None] - prefix_b) + t_b   # inclusive
        comp_u = t_f.sum(axis=1) + t_b.sum(axis=1)
        total_b = total_b_u[uk]

        # per-point affine collective coefficients
        per_byte, per_message = _collective_coeffs(
            cax, c, cl, nn,
            None if bwmul is None else bwmul[sl],
            None if latmul is None else latmul[sl])

        # pipeline terms: (k,)
        nbytes_in = batch_f * wax.bytes_per_sample[w]
        t_io = cax.disk_lat[c] + nbytes_in / cax.disk_bw[c]
        if wax.any_meas_io:
            t_io = np.where(wax.has_meas_io[w],
                            wax.t_io_meas[w] * batch_f
                            / wax.batch_default[w],
                            t_io)
        t_h2d = cax.h2d_lat[c] + nbytes_in / cax.h2d_bw[c]

        out["io_h2d"][sl] = t_io + t_h2d
        out["t_h2d"][sl] = t_h2d
        out["comp"][sl] = comp_u[uk]
        out["sum_c"][sl] = per_byte * gradsum[w] + per_message * ncomm[w]
        # WFBP residual (non_overlapped_comm_batch, affine form): the
        # comm prefix sum at layer l is per_byte*cumgrad[l] +
        # per_message*cumcount[l]; candidates masked to comm layers
        # (t_c > 0 <=> grad > 0 when n > 1; when n <= 1 both
        # coefficients are 0, every candidate is <= total_b and the
        # clamp yields the same exact 0.0)
        cand = suffix_b_u[uk]
        cand += per_byte[:, None] * cumgrad[w]
        cand += per_message[:, None] * cumcount[w]
        cand *= comm_mask[w]
        out["tc_no"][sl] = np.maximum(
            cand.max(axis=1, initial=0.0) - total_b, 0.0)
        out["t_u"][sl] = 3.0 * wax.param_bytes[w] / cax.hbm_bw[c]
        out["n_f"][sl] = n_f
        out["batch_f"][sl] = batch_f

        # bucket-timeline residuals: the timeline_residual makespan
        # with the duration suffix sum in affine form — release times
        # from the unique-row backward suffix, one fused multiply-add +
        # masked max over the (k, B) bucket axis per spec
        for i, ((bt, sufnb, sufcnt), (_, ov_comm)) in \
                enumerate(zip(btables, tl_specs)):
            if ov_comm:
                release_u = np.take_along_axis(
                    suffix_b_u, bt.release_layer[uw], axis=1)
            else:
                release_u = np.broadcast_to(
                    total_b_u[:, None], (len(uw), bt.n_buckets))
            cand = release_u[uk]
            cand += per_byte[:, None] * sufnb[w]
            cand += per_message[:, None] * sufcnt[w]
            cand *= bt.mask[w]
            out[f"tl{i}"][sl] = np.maximum(
                cand.max(axis=1, initial=0.0) - total_b, 0.0)
    return out


# ----------------------------------------------------------------------
# Tier 2: per-scenario policy select — cheap (S,) vector ops.
# ----------------------------------------------------------------------
def _policy_select(pax: _PolicyAxis, polidx: np.ndarray,
                   kc: dict[str, np.ndarray],
                   kidx: np.ndarray | None,
                   chain_extra: np.ndarray | None = None
                   ) -> dict[str, np.ndarray]:
    """Gather each scenario's kernel point (``kidx=None`` means the
    identity map) and select its policy's steady-state form — Eqs. (2),
    (3), (5) and the late-H2D variants for closed-form policies, the
    bucket-timeline residual for schedule-dependent ones — plus the
    zero-comm weak-scaling baseline with the *same* policy (what
    ``_fast_eval`` / ``_sim_eval`` compute for the speedup column).

    ``chain_extra`` is an additive extension of the GPU/update chain
    (the fault model's serialized checkpoint restores, which gate the
    update broadcast).  It sits *inside* the pipeline max, so an
    I/O-bound pipeline absorbs part of the penalty — exactly what the
    event-driven DAG produces.  The zero-comm baseline ``t1`` is
    unaffected (it is the hypothetical fault-free single-GPU time)."""
    def g(a: np.ndarray) -> np.ndarray:
        return a if kidx is None else a[kidx]

    io_h2d, t_h2d = g(kc["io_h2d"]), g(kc["t_h2d"])
    comp, sum_c = g(kc["comp"]), g(kc["sum_c"])
    tc_no, t_u = g(kc["tc_no"]), g(kc["t_u"])
    n_f, batch_f = g(kc["n_f"]), g(kc["batch_f"])

    ov_io = pax.overlap_io[polidx]
    ov_comm = pax.overlap_comm[polidx]
    early = pax.h2d_early[polidx]

    comm_term = np.where(ov_comm, tc_no, sum_c)     # WFBP residual or full
    # Schedule-dependent overrides.  Bucketed policies substitute their
    # bucket-timeline residual column; priority-only policies need no
    # override — the net channel is work-conserving, so reordering
    # never moves the last comm finish and the per-layer term already
    # selected (tc_no / sum_c) *is* their residual.
    spec_of = pax.tl_spec[polidx]
    for i in range(len(pax.tl_specs)):
        comm_term = np.where(spec_of == i, g(kc[f"tl{i}"]), comm_term)
    gpu_chain = comp + comm_term + t_u
    if chain_extra is not None:
        gpu_chain = gpu_chain + chain_extra
    eq2 = io_h2d + gpu_chain                        # no I/O overlap
    eq_early = np.maximum(io_h2d, gpu_chain)        # Eq. (3)/(5)
    eq_late = np.maximum(io_h2d, t_h2d + gpu_chain)  # late-H2D variants
    t_iter = np.where(~ov_io, eq2, np.where(early, eq_early, eq_late))

    base_chain = comp + t_u                         # zero-comm baseline
    t1 = np.where(~ov_io, io_h2d + base_chain,
                  np.where(early, np.maximum(io_h2d, base_chain),
                           np.maximum(io_h2d, t_h2d + base_chain)))

    # method tier code: index into resulttable.METHOD_LABELS (0 =
    # closed form, 1 = bucket timeline, 2 = simulator-only — the
    # caller discards tier-2 rows for the simulator fallback).  Kept
    # as an int column so the select stays label-free; the table
    # assembly gathers the labels.
    return {
        "batch": batch_f,
        "iteration_time_s": t_iter,
        "samples_per_sec": n_f * batch_f / t_iter,
        "speedup": n_f * t1 / t_iter,
        "t_comm_s": sum_c,
        "t_comp_s": comp,
        "method_code": pax.tier[polidx],
    }


def select_to_columns(cols: dict[str, np.ndarray],
                      labels: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Assemble a tidy columnar table (:data:`repro_torch.core.resulttable.COLUMNS`
    order) from a :func:`_policy_select` output plus per-scenario label
    columns (object arrays, already gathered).  Shared by both batched
    backends — the NumPy grid/list front ends here and
    :class:`repro_torch.core.batched_torch.TorchGridRun`.

    The tail columns ``t_mean_s``/``t_p95_s``/``t_p99_s`` come from the
    straggler Monte Carlo pass when present; deterministic rows (no
    straggler spec, or zero jitter) default to ``iteration_time_s`` —
    the distribution is a point mass there.
    """
    t_iter = np.asarray(cols["iteration_time_s"])
    return {
        "workload": labels["workload"],
        "cluster": labels["cluster"],
        "n_workers": labels["n_workers"],
        "policy": labels["policy"],
        "collective": labels["collective"],
        "interconnect": labels["interconnect"],
        "het": labels["het"],
        "straggler": labels["straggler"],
        "sync_k": labels["sync_k"],
        "faults": labels["faults"],
        "batch_per_gpu": np.asarray(cols["batch"]).astype(np.int64),
        "iteration_time_s": t_iter,
        "samples_per_sec": np.asarray(cols["samples_per_sec"]),
        "speedup": np.asarray(cols["speedup"]),
        "t_comm_s": np.asarray(cols["t_comm_s"]),
        "t_comp_s": np.asarray(cols["t_comp_s"]),
        "t_mean_s": np.asarray(cols.get("t_mean_s", t_iter)),
        "t_p95_s": np.asarray(cols.get("t_p95_s", t_iter)),
        "t_p99_s": np.asarray(cols.get("t_p99_s", t_iter)),
        "method": METHOD_LABELS[np.asarray(cols["method_code"])],
    }


# ----------------------------------------------------------------------
# Failure-model Monte Carlo: per-draw kernel evaluation, reduced to
# tails (straggler jitter, K-of-N sync, fault injection).
# ----------------------------------------------------------------------
def _apply_mc_tails(wax: _WorkloadAxis, cax: _ClusterAxis, pax: _PolicyAxis,
                    widx: np.ndarray, cidx: np.ndarray, coll: np.ndarray,
                    n: np.ndarray, batch: np.ndarray, polidx: np.ndarray,
                    hks: np.ndarray, wtab: dict[str, np.ndarray],
                    bwmul: np.ndarray | None, latmul: np.ndarray | None,
                    st_specs: Sequence, stidx: np.ndarray,
                    cols: dict[str, np.ndarray], seed: int,
                    active: np.ndarray | None = None,
                    synck: np.ndarray | None = None,
                    ft_specs: Sequence = (None,),
                    fidx: np.ndarray | None = None) -> None:
    """Attach ``t_mean_s``/``t_p95_s``/``t_p99_s`` to a
    :func:`_policy_select` output in place.

    Every input array is per-*row*: ``widx``/``cidx``/``coll``/``n``/
    ``batch`` locate the row's kernel point, ``polidx`` its policy,
    ``hks`` its padded worker-table row in ``wtab``
    (:func:`repro_torch.core.het.worker_table_rows`), ``stidx`` its spec in
    ``st_specs`` (parsed :class:`repro_torch.core.het.StragglerSpec` or
    ``None``), ``bwmul``/``latmul`` its deterministic slowest-link
    multipliers, ``synck`` its normalized sync threshold (``0`` = full
    sync) and ``fidx`` its spec in ``ft_specs`` (parsed
    :class:`repro_torch.core.het.FaultSpec` or ``None``).  Deterministic rows
    (no stochastic spec) keep the point-mass default — tails equal to
    ``iteration_time_s``, bit-exact.

    Stochastic rows take a Monte Carlo pass: per draw ``d`` the
    bottleneck theorem applies with multiplier ``kth_w(J[d, w] /
    speed_w)`` — the K-th order statistic of the jitter folded with the
    het profile's per-worker rates (``K = n`` under full sync recovers
    the max; the slow worker and the unlucky worker need not coincide,
    and under K-of-N each draw elects its *own* K-th worker) — so each
    draw is one deterministic kernel evaluation at that ``tmul``.  A
    fault spec contributes a per-draw penalty ``restart * crashes[d]``
    (crash counts from
    :meth:`~repro_torch.core.het.FaultSpec.crash_matrix`) injected into the
    GPU/update chain via ``_policy_select(chain_extra=...)``: restores
    serialize on the shared checkpoint store and gate the update
    broadcast, so they extend the chain *inside* the pipeline max — an
    I/O-bound pipeline absorbs part of the penalty, exactly as the
    event-driven DAG does.  Rows sharing
    ``(kernel point, policy, worker table, sync_k)`` are deduplicated
    first, per-point draw multipliers are built once per unique
    ``(worker-table row, sync_k)`` pair (the ``(D, W)`` matrices come
    from :meth:`~repro_torch.core.het.StragglerSpec.draw_matrix`, keyed by
    ``(spec, n, seed)`` so every backend and shard consumes the
    identical sample; the draw count is the straggler spec's when one
    is present, else the fault spec's), and the expanded ``point x
    draw`` set streams through the ordinary two-tier kernel in blocks
    of roughly :data:`KERNEL_CHUNK` rows.  The per-draw iteration times
    reduce to mean/p95/p99 with ``np.quantile`` on the host — shared by
    the torch backend, which guarantees the draw-for-draw <= 1e-6
    agreement.

    ``active=False`` rows (simulator-fallback policies) are skipped:
    their whole row, tails included, is overwritten by the per-draw
    oracle path in :mod:`repro_torch.core.sweep`.
    """
    t_iter = np.asarray(cols["iteration_time_s"])
    cols["t_mean_s"] = t_iter.copy()
    cols["t_p95_s"] = t_iter.copy()
    cols["t_p99_s"] = t_iter.copy()
    if synck is None:
        synck = np.zeros(len(t_iter), dtype=np.int64)
    if fidx is None:
        fidx = np.zeros(len(t_iter), dtype=np.int64)
    for si, st in enumerate(st_specs):
        st_live = st is not None and not st.is_deterministic
        for fi, ft in enumerate(ft_specs):
            ft_live = ft is not None and not ft.is_deterministic
            if not (st_live or ft_live):
                continue
            sel = (stidx == si) & (fidx == fi)
            if active is not None:
                sel = sel & active
            rows = np.nonzero(sel)[0]
            if not len(rows):
                continue
            # one MC evaluation per unique (kernel point, policy,
            # worker table, sync_k) tuple — rows sharing all four see
            # identical draws
            key = np.stack([widx[rows], cidx[rows], coll[rows], n[rows],
                            batch[rows], polidx[rows], hks[rows],
                            synck[rows]], axis=1)
            _, rep, uinv = np.unique(key, axis=0, return_index=True,
                                     return_inverse=True)
            urows = rows[rep]
            U = len(urows)
            D = st.draws if st_live else ft.draws
            tmuls = np.empty((U, D))
            pens = np.zeros((U, D)) if ft_live else None
            hkpairs = np.stack([hks[urows], synck[urows]], axis=1)
            for h, k in np.unique(hkpairs, axis=0):
                pts = np.nonzero((hkpairs[:, 0] == h)
                                 & (hkpairs[:, 1] == k))[0]
                nw = int(wtab["n"][h])
                J = (st.draw_matrix(nw, seed) if st_live
                     else np.ones((D, nw)))
                times = J * wtab["inv_speed"][h, :nw]      # (D, nw)
                keff = nw if k == 0 else min(max(int(k), 1), nw)
                if keff >= nw:
                    tmuls[pts] = times.max(axis=1)
                else:
                    tmuls[pts] = np.partition(
                        times, keff - 1, axis=1)[:, keff - 1]
                if ft_live:
                    crashes = ft.crash_matrix(
                        nw, seed, draws=D).sum(axis=1)     # (D,)
                    pens[pts] = ft.restart * crashes
            mean_u = np.empty(U)
            p95_u = np.empty(U)
            p99_u = np.empty(U)
            blk = max(1, KERNEL_CHUNK // D)
            for lo in range(0, U, blk):
                pt = urows[lo:lo + blk]
                m = len(pt)
                rp = np.repeat(pt, D)
                kc = _kernel_cols(
                    wax, cax, widx[rp], cidx[rp], coll[rp], n[rp],
                    batch[rp], tl_specs=pax.tl_specs,
                    tmul=tmuls[lo:lo + m].ravel(),
                    bwmul=None if bwmul is None else bwmul[rp],
                    latmul=None if latmul is None else latmul[rp])
                ti = _policy_select(
                    pax, polidx[rp], kc, kidx=None,
                    chain_extra=None if pens is None
                    else pens[lo:lo + m].ravel())[
                    "iteration_time_s"].reshape(m, D)
                mean_u[lo:lo + m] = ti.mean(axis=1)
                p95_u[lo:lo + m] = np.quantile(ti, 0.95, axis=1)
                p99_u[lo:lo + m] = np.quantile(ti, 0.99, axis=1)
            cols["t_mean_s"][rows] = mean_u[uinv]
            cols["t_p95_s"][rows] = p95_u[uinv]
            cols["t_p99_s"][rows] = p99_u[uinv]


# ----------------------------------------------------------------------
# Grid front end: codes straight from the axes, no Scenario objects.
# ----------------------------------------------------------------------
def _axis_codes(sizes: Sequence[int]) -> list[np.ndarray]:
    """Flat cross-product code vectors, rightmost axis fastest — the
    exact :meth:`ScenarioGrid.expand` order."""
    out = []
    for i, size in enumerate(sizes):
        after = int(np.prod(sizes[i + 1:], dtype=np.int64))
        before = int(np.prod(sizes[:i], dtype=np.int64))
        out.append(np.tile(np.repeat(np.arange(size), after), before))
    return out


class GridEvaluator:
    """A :class:`ScenarioGrid` prepared for batched evaluation.

    Builds the axis tables, the kernel-grid code vectors (policy axis
    dropped), the scenario -> kernel-point map and the row label lists
    directly from the grid's cross-product structure — no per-scenario
    Python objects at all.  Closed-form *and* bucket-timeline policies
    are both batched; scenarios whose policy has neither form come
    back as ``None`` rows and :meth:`scenario_at` materializes just
    those for the simulator fallback.

    The evaluator holds only *structure*; :meth:`run` computes the
    numbers.  Get instances through :func:`grid_evaluator`, which
    memoizes them by grid value + workload-table identity.
    """

    def __init__(self, grid: ScenarioGrid):
        grid.validate_axes()
        self.grid = grid
        nW, nC = len(grid.workloads), len(grid.clusters)
        nK, nP = len(grid.worker_counts), len(grid.policies)
        nA, nI = len(grid.collectives), len(grid.interconnects)
        nH, nT = len(grid.het_profiles), len(grid.stragglers)
        nQ, nF = len(grid.sync_ks), len(grid.faults)
        self._sizes = (nW, nC, nK, nP, nA, nI, nH, nT, nQ, nF)
        self.n_scenarios = (nW * nC * nK * nP * nA * nI * nH * nT
                            * nQ * nF)

        self._wax = _workload_axis(grid.workloads)
        pairs = [(c, ic) for c in grid.clusters for ic in grid.interconnects]
        self._cax = _cluster_axis(pairs)
        self._pax = _policy_axis(grid.policies)

        # Kernel grid: the scenario product with the policy, straggler
        # and fault axes dropped — order (workloads, clusters, workers,
        # collectives, interconnects, het_profiles, sync_ks), rightmost
        # fastest.  The straggler and fault axes never change a
        # deterministic kernel point (jitter and crash penalties only
        # enter the Monte Carlo pass); the het axis does, through the
        # bottleneck multipliers, and the sync_k axis does too — it
        # picks *which* order statistic of the per-worker rates gates
        # the iteration.  O(K) int vectors; every per-*scenario*
        # quantity is derived per chunk instead (see _scenario_codes),
        # so preparation stays O(axes + K) however large the scenario
        # product is.
        kw, kc, kk, ka, ki, kh, kq = _axis_codes(
            (nW, nC, nK, nA, nI, nH, nQ))
        self._kwidx = kw
        self._kcidx = kc * nI + ki              # (cluster, interconnect) pair
        self._kcoll = np.array(
            [_COLLECTIVE_CODE[c] for c in grid.collectives],
            dtype=np.int64)[ka]
        self._kn = np.array([int(k) for k in grid.worker_counts],
                            dtype=np.int64)[kk]
        self._kbatch = np.full(len(kw), grid.batch_per_gpu or 0,
                               dtype=np.int64)
        self._khk = kh * nK + kk                # (het profile, n) pair row
        sk_values = np.array(
            [normalize_sync_k(k) for k in grid.sync_ks], dtype=np.int64)
        self._ksynck = sk_values[kq]            # 0 = full sync
        _check_batch_locked(self._wax, kw, self._kbatch)

        # Heterogeneity: one padded per-worker table row per (profile,
        # n_workers) pair, reduced once to the bottleneck multipliers
        # and gathered per kernel point.  All-homogeneous grids keep
        # the multipliers as None so the kernel's fast path stays
        # literally untouched (not merely bit-identical) — exact even
        # under K-of-N sync, where every order statistic of an all-ones
        # rate vector is 1.0; a partial-sync threshold only changes the
        # *deterministic* kernel point when workers actually differ.
        profiles = [het_mod.parse_het_profile(h) for h in grid.het_profiles]
        self._wtab = het_mod.worker_table_rows(
            [(prof, int(n)) for prof in profiles
             for n in grid.worker_counts])
        self._any_het = any(p is not None for p in profiles)
        self._any_synck = bool((sk_values != 0).any())
        if self._any_het:
            tm, bm, lm = analytical.worker_bottleneck(
                self._wtab["inv_speed"], self._wtab["bw_mult"],
                self._wtab["lat_mult"])
            self._kbwmul = bm[self._khk]
            self._klatmul = lm[self._khk]
            if self._any_synck:
                nrow = self._wtab["n"][self._khk]
                self._ktmul = analytical.kth_order_statistic(
                    self._wtab["inv_speed"][self._khk], nrow,
                    analytical.effective_sync_k(self._ksynck, nrow))
            else:
                self._ktmul = tm[self._khk]
        else:
            self._ktmul = self._kbwmul = self._klatmul = None
        self._st_specs = [het_mod.parse_straggler(s)
                          for s in grid.stragglers]
        self._ft_specs = [het_mod.parse_fault(f) for f in grid.faults]
        self._any_mc = (
            any(s is not None and not s.is_deterministic
                for s in self._st_specs)
            or any(f is not None and not f.is_deterministic
                   for f in self._ft_specs))

        per_policy = self.n_scenarios // nP if nP else 0
        self.n_fast = per_policy * int(self._pax.has_fast.sum())
        self.n_timeline = per_policy * int(self._pax.has_tl.sum())
        self.all_batched = \
            self.n_fast + self.n_timeline == self.n_scenarios

        # Per-axis label values (tiny object arrays, fancy-indexed per
        # chunk by the derived codes).
        self._wl_values = np.array(list(grid.workloads), dtype=object)
        self._cl_values = np.array(list(grid.clusters), dtype=object)
        self._n_values = np.array([int(k) for k in grid.worker_counts],
                                  dtype=np.int64)
        self._pol_values = np.array(list(grid.policies), dtype=object)
        self._coll_values = np.array(list(grid.collectives), dtype=object)
        self._ic_values = np.array(
            [normalize_interconnect(ic) for ic in grid.interconnects],
            dtype=object)
        self._ht_values = np.array(
            [het_mod.normalize_het(h) for h in grid.het_profiles],
            dtype=object)
        self._st_values = np.array(
            [het_mod.normalize_straggler(s) for s in grid.stragglers],
            dtype=object)
        self._sk_values = sk_values
        self._fl_values = np.array(
            [het_mod.normalize_fault(f) for f in grid.faults],
            dtype=object)

    def __len__(self) -> int:
        return self.n_scenarios

    def _scenario_codes(self, lo: int, hi: int) -> dict[str, np.ndarray]:
        """Axis codes, the kernel-point map and the fast mask for flat
        scenario indices ``[lo, hi)``, derived arithmetically from the
        expand() order (rightmost axis fastest) — O(chunk) work and
        memory, nothing per-scenario is ever stored."""
        nW, nC, nK, nP, nA, nI, nH, nT, nQ, nF = self._sizes
        r = np.arange(lo, hi, dtype=np.int64)
        fli = r % nF
        r //= nF
        ski = r % nQ
        r //= nQ
        sti = r % nT
        r //= nT
        hp = r % nH
        r //= nH
        ii = r % nI
        r //= nI
        ai = r % nA
        r //= nA
        pi = r % nP
        r //= nP
        ki = r % nK
        r //= nK
        ci = r % nC
        wi = r // nC
        kidx = ((((((wi * nC + ci) * nK + ki) * nA + ai) * nI + ii) * nH
                 + hp) * nQ + ski)
        return {"wi": wi, "ci": ci, "ki": ki, "pi": pi, "ai": ai, "ii": ii,
                "hi": hp, "sti": sti, "ski": ski, "fli": fli, "kidx": kidx,
                "batched": self._pax.has_fast[pi] | self._pax.has_tl[pi]}

    def _label_columns(self, codes: dict[str, np.ndarray]) -> dict:
        return {
            "workload": self._wl_values[codes["wi"]],
            "cluster": self._cl_values[codes["ci"]],
            "n_workers": self._n_values[codes["ki"]],
            "policy": self._pol_values[codes["pi"]],
            "collective": self._coll_values[codes["ai"]],
            "interconnect": self._ic_values[codes["ii"]],
            "het": self._ht_values[codes["hi"]],
            "straggler": self._st_values[codes["sti"]],
            "sync_k": self._sk_values[codes["ski"]],
            "faults": self._fl_values[codes["fli"]],
        }

    def _apply_tails(self, codes: dict[str, np.ndarray],
                     cols: dict[str, np.ndarray], seed: int) -> None:
        """Attach the tail columns for the rows of ``codes`` in place:
        the point-mass default everywhere, overwritten by the straggler
        Monte Carlo pass (:func:`_apply_mc_tails`) on stochastic rows.
        Simulator-fallback rows are excluded — their tails come from
        the per-draw oracle in :mod:`repro_torch.core.sweep`."""
        if not self._any_mc:
            t_iter = np.asarray(cols["iteration_time_s"])
            cols["t_mean_s"] = t_iter
            cols["t_p95_s"] = t_iter
            cols["t_p99_s"] = t_iter
            return
        k = codes["kidx"]
        _apply_mc_tails(
            self._wax, self._cax, self._pax,
            self._kwidx[k], self._kcidx[k], self._kcoll[k], self._kn[k],
            self._kbatch[k], codes["pi"], self._khk[k], self._wtab,
            None if self._kbwmul is None else self._kbwmul[k],
            None if self._klatmul is None else self._klatmul[k],
            self._st_specs, codes["sti"], cols, seed,
            active=codes["batched"], synck=self._ksynck[k],
            ft_specs=self._ft_specs, fidx=codes["fli"])

    def run(self, seed: int = 0) -> "GridRun":
        """Evaluate the kernel grid (fresh numbers every call) and
        return the per-run table materializer.  ``seed`` keys the
        straggler Monte Carlo draws (ignored on deterministic grids)."""
        return GridRun(self, _kernel_cols(
            self._wax, self._cax, self._kwidx, self._kcidx,
            self._kcoll, self._kn, self._kbatch,
            tl_specs=self._pax.tl_specs,
            tmul=self._ktmul, bwmul=self._kbwmul, latmul=self._klatmul),
            seed=seed)

    def run_span(self, lo: int, hi: int, seed: int = 0):
        """Evaluate just the flat scenario indices ``[lo, hi)`` —
        kernel restricted to the unique kernel points the span touches,
        so a worker evaluating one shard never pays for the whole grid.
        Returns ``(table, batched)``: the columnar result table and the
        per-row batched mask (``False`` rows carry tier-2 placeholder
        numbers the caller must overwrite with the simulator — see
        :mod:`repro_torch.core.parallel`)."""
        codes = self._scenario_codes(lo, hi)
        uk, inv = np.unique(codes["kidx"], return_inverse=True)
        kc = _kernel_cols(
            self._wax, self._cax, self._kwidx[uk], self._kcidx[uk],
            self._kcoll[uk], self._kn[uk], self._kbatch[uk],
            tl_specs=self._pax.tl_specs,
            tmul=None if self._ktmul is None else self._ktmul[uk],
            bwmul=None if self._kbwmul is None else self._kbwmul[uk],
            latmul=None if self._klatmul is None else self._klatmul[uk])
        cols = _policy_select(self._pax, codes["pi"], kc, inv)
        self._apply_tails(codes, cols, seed)
        return (select_to_columns(cols, self._label_columns(codes)),
                codes["batched"])

    def scenario_at(self, i: int) -> Scenario:
        """Materialize flat index ``i`` (used for simulator-fallback
        entries only)."""
        return self.grid.scenario_at(i)


class GridRun:
    """One evaluation of a grid: the ``(K,)`` kernel columns plus the
    shared structure, materializing columnar result tables chunk by
    chunk (:meth:`table_slice` is the hot path; :meth:`rows_slice` is
    the per-row compat view)."""

    def __init__(self, ev: GridEvaluator, kernel_cols: dict[str, np.ndarray],
                 seed: int = 0):
        self._ev = ev
        self._kc = kernel_cols
        self._seed = seed

    def __len__(self) -> int:
        return self._ev.n_scenarios

    def columns_slice(self, lo: int, hi: int) -> dict[str, np.ndarray]:
        """Numeric result columns (plus ``method`` labels as a Python
        list) for flat scenario indices ``[lo, hi)`` — the
        policy-selected values before tidy-table assembly.  The
        kernel-only surface the throughput benchmark times and the torch
        backend's differential gate compares against."""
        ev = self._ev
        codes = ev._scenario_codes(lo, hi)
        cols = _policy_select(ev._pax, codes["pi"], self._kc, codes["kidx"])
        ev._apply_tails(codes, cols, self._seed)
        cols["method"] = METHOD_LABELS[cols.pop("method_code")].tolist()
        return cols

    def table_slice(self, lo: int, hi: int):
        """Columnar result table for flat scenario indices ``[lo, hi)``
        in grid order — label columns gathered from the per-axis value
        arrays, numeric columns straight from the policy select.
        Returns ``(table, batched)`` where ``batched`` is the per-row
        mask; ``False`` rows carry tier-2 placeholder numbers (their
        policy needs the simulator) that the caller overwrites via
        :func:`repro_torch.core.resulttable.fill_rows`."""
        ev = self._ev
        codes = ev._scenario_codes(lo, hi)
        cols = _policy_select(ev._pax, codes["pi"], self._kc, codes["kidx"])
        ev._apply_tails(codes, cols, self._seed)
        return (select_to_columns(cols, ev._label_columns(codes)),
                codes["batched"])

    def rows_slice(self, lo: int, hi: int) -> list[dict | None]:
        """Batched rows for flat scenario indices ``[lo, hi)`` in grid
        order; entries whose policy needs the simulator come back as
        ``None`` for the caller to fill."""
        table, batched = self.table_slice(lo, hi)
        rows: list[dict | None] = rows_from_table(table)
        if not self._ev.all_batched:
            for i in np.nonzero(~batched)[0].tolist():
                rows[i] = None                # selected a bogus equation
        return rows


#: Structure memo: prepared evaluators keyed by grid value + the
#: identity of the resolved workload tables (holding the tables alive
#: keeps the ids stable; a re-resolved table — e.g. an on-disk trace
#: whose mtime changed — misses the memo and rebuilds).
_EVALUATOR_MEMO: dict = {}
_MEMO_LIMIT = 64


def grid_evaluator(grid: ScenarioGrid) -> GridEvaluator:
    """Memoized :class:`GridEvaluator` for ``grid`` (falls back to a
    fresh instance when the grid isn't hashable, e.g. list-valued
    axes)."""
    try:
        tables = tuple(resolve_workload(w) for w in grid.workloads)
        key = (grid, tuple(id(t) for t in tables))
        hash(key)
    except TypeError:
        return GridEvaluator(grid)
    hit = _EVALUATOR_MEMO.get(key)
    if hit is not None:
        return hit[0]
    if len(_EVALUATOR_MEMO) >= _MEMO_LIMIT:
        _EVALUATOR_MEMO.clear()
    ev = GridEvaluator(grid)
    _EVALUATOR_MEMO[key] = (ev, tables)
    return ev


def evaluator_cached(grid: ScenarioGrid) -> bool:
    """True when :func:`grid_evaluator` would hit the structure memo —
    a pure probe (nothing is built, no entry is added), which is how
    the sweep service (:mod:`repro_torch.core.service`) accounts cache
    hit/miss rates without perturbing the cache it is measuring."""
    try:
        tables = tuple(resolve_workload(w) for w in grid.workloads)
        key = (grid, tuple(id(t) for t in tables))
        hash(key)
    except (TypeError, ValueError):
        return False
    return key in _EVALUATOR_MEMO


# ----------------------------------------------------------------------
# Scenario-list front end (arbitrary iterables, already validated).
# ----------------------------------------------------------------------
def scenario_axes(scenarios: Sequence[Scenario]):
    """One Python pass over a scenario list: resolve the unique
    workload/cluster-pair/policy axes and the per-scenario code
    vectors.  Returns ``(wax, cax, pax, widx, cidx, polidx, coll, n,
    batch)`` — the inputs of the two-tier kernel with the identity
    scenario -> kernel-point map.  Shared by :func:`eval_scenarios`
    and the torch backend's list front end
    (:func:`repro_torch.core.batched_torch.eval_scenarios_table_torch`), raising
    ``ValueError`` if any scenario's policy has neither a closed nor a
    bucket-timeline form.
    """
    wl_key: dict[str, int] = {}
    pair_key: dict[tuple[str, str | None], int] = {}
    pol_key: dict[str, int] = {}
    widx = np.empty(len(scenarios), dtype=np.int64)
    cidx = np.empty(len(scenarios), dtype=np.int64)
    polidx = np.empty(len(scenarios), dtype=np.int64)
    coll = np.empty(len(scenarios), dtype=np.int64)
    n = np.empty(len(scenarios), dtype=np.int64)
    batch = np.empty(len(scenarios), dtype=np.int64)
    for i, s in enumerate(scenarios):
        wi = wl_key.get(s.workload)
        if wi is None:
            wi = wl_key[s.workload] = len(wl_key)
        widx[i] = wi
        pk = (s.cluster, s.interconnect)
        ci = pair_key.get(pk)
        if ci is None:
            ci = pair_key[pk] = len(pair_key)
        cidx[i] = ci
        pi = pol_key.get(s.policy)
        if pi is None:
            pi = pol_key[s.policy] = len(pol_key)
        polidx[i] = pi
        coll[i] = _COLLECTIVE_CODE[s.collective]
        n[i] = s.n_workers
        batch[i] = s.batch_per_gpu or 0
    wax = _workload_axis(list(wl_key))
    _check_batch_locked(wax, widx, batch)
    cax = _cluster_axis(list(pair_key))
    pax = _policy_axis(list(pol_key))
    batched_ok = pax.has_fast | pax.has_tl
    if not bool(batched_ok[polidx].all()):
        bad = [pax.names[int(p)]
               for p in np.unique(polidx[~batched_ok[polidx]])]
        raise ValueError(f"policies with neither a closed form nor a "
                         f"bucket-timeline form cannot take the batched "
                         f"path: {bad}")
    return wax, cax, pax, widx, cidx, polidx, coll, n, batch


def scenario_het_axes(scenarios: Sequence[Scenario]):
    """One Python pass over a scenario list: the heterogeneity /
    failure-model structure the kernel and the Monte Carlo pass need.
    Returns ``(hks, wtab, tmul, bwmul, latmul, st_specs, stidx, synck,
    ft_specs, fidx)`` — per-scenario rows into a padded worker table
    over the unique ``(het, n_workers)`` pairs, the reduced bottleneck
    multiplier vectors (``None`` when every scenario is homogeneous,
    keeping the kernel's fast path untouched; the compute multiplier is
    the ``sync_k``-th order statistic when a partial-sync threshold is
    present), the unique parsed straggler specs with the per-scenario
    index, the normalized per-scenario sync thresholds (``0`` = full
    sync) and the unique parsed fault specs with the per-scenario
    index.  Shared with the torch list front end so both backends agree
    on structure."""
    pair_key: dict[tuple[str, int], int] = {}
    st_key: dict[str, int] = {}
    fl_key: dict[str, int] = {}
    hks = np.empty(len(scenarios), dtype=np.int64)
    stidx = np.empty(len(scenarios), dtype=np.int64)
    fidx = np.empty(len(scenarios), dtype=np.int64)
    synck = np.empty(len(scenarios), dtype=np.int64)
    any_het = False
    for i, s in enumerate(scenarios):
        hspec = het_mod.normalize_het(s.het)
        pk = (hspec, int(s.n_workers))
        j = pair_key.get(pk)
        if j is None:
            j = pair_key[pk] = len(pair_key)
        hks[i] = j
        if hspec != "none":
            any_het = True
        sk = het_mod.normalize_straggler(s.straggler)
        si = st_key.get(sk)
        if si is None:
            si = st_key[sk] = len(st_key)
        stidx[i] = si
        fl = het_mod.normalize_fault(s.faults)
        fi = fl_key.get(fl)
        if fi is None:
            fi = fl_key[fl] = len(fl_key)
        fidx[i] = fi
        synck[i] = normalize_sync_k(s.sync_k)
    wtab = het_mod.worker_table_rows(
        [(het_mod.parse_het_profile(h), n) for h, n in pair_key])
    if any_het:
        tm, bm, lm = analytical.worker_bottleneck(
            wtab["inv_speed"], wtab["bw_mult"], wtab["lat_mult"])
        bwmul, latmul = bm[hks], lm[hks]
        if bool((synck != 0).any()):
            nrow = wtab["n"][hks]
            tmul = analytical.kth_order_statistic(
                wtab["inv_speed"][hks], nrow,
                analytical.effective_sync_k(synck, nrow))
        else:
            tmul = tm[hks]
    else:
        tmul = bwmul = latmul = None
    st_specs = [het_mod.parse_straggler(s) for s in st_key]
    ft_specs = [het_mod.parse_fault(f) for f in fl_key]
    return (hks, wtab, tmul, bwmul, latmul, st_specs, stidx,
            synck, ft_specs, fidx)


def scenario_labels(scenarios: Sequence[Scenario]) -> dict[str, np.ndarray]:
    """Per-scenario label columns (object arrays) for a scenario list —
    the list front end's counterpart of the grid's per-axis value
    arrays.  Shared with :func:`repro_torch.core.batched_torch.eval_scenarios_table_torch`."""
    return {
        "workload": np.array([s.workload for s in scenarios], dtype=object),
        "cluster": np.array([s.cluster for s in scenarios], dtype=object),
        "n_workers": np.array([s.n_workers for s in scenarios],
                              dtype=np.int64),
        "policy": np.array([s.policy for s in scenarios], dtype=object),
        "collective": np.array([s.collective for s in scenarios],
                               dtype=object),
        "interconnect": np.array(
            [normalize_interconnect(s.interconnect) for s in scenarios],
            dtype=object),
        "het": np.array([het_mod.normalize_het(s.het) for s in scenarios],
                        dtype=object),
        "straggler": np.array(
            [het_mod.normalize_straggler(s.straggler) for s in scenarios],
            dtype=object),
        "sync_k": np.array(
            [normalize_sync_k(s.sync_k) for s in scenarios],
            dtype=np.int64),
        "faults": np.array(
            [het_mod.normalize_fault(s.faults) for s in scenarios],
            dtype=object),
    }


def eval_scenarios_table(scenarios: Sequence[Scenario],
                         seed: int = 0) -> dict[str, np.ndarray]:
    """Columnar result table (input order) for a list of
    batched-path-eligible scenarios (closed-form or bucket-timeline
    policies); one Python pass to build code vectors, then the same
    two-tier kernel the grid front end uses (with the identity
    scenario -> kernel-point map).  ``seed`` keys the straggler Monte
    Carlo draws for stochastic scenarios.

    Raises ``ValueError`` if any scenario's policy has neither form —
    callers (:func:`repro_torch.core.sweep.sweep`) partition first.
    """
    wax, cax, pax, widx, cidx, polidx, coll, n, batch = \
        scenario_axes(scenarios)
    (hks, wtab, tmul, bwmul, latmul, st_specs, stidx,
     synck, ft_specs, fidx) = scenario_het_axes(scenarios)
    kc = _kernel_cols(wax, cax, widx, cidx, coll, n, batch,
                      tl_specs=pax.tl_specs,
                      tmul=tmul, bwmul=bwmul, latmul=latmul)
    cols = _policy_select(pax, polidx, kc, kidx=None)
    _apply_mc_tails(wax, cax, pax, widx, cidx, coll, n, batch, polidx,
                    hks, wtab, bwmul, latmul, st_specs, stidx,
                    cols, seed, synck=synck, ft_specs=ft_specs, fidx=fidx)
    return select_to_columns(cols, scenario_labels(scenarios))


def eval_scenarios(scenarios: Sequence[Scenario],
                   seed: int = 0) -> list[dict]:
    """Batched rows (input order) for a scenario list — the per-row
    view of :func:`eval_scenarios_table`."""
    if not scenarios:
        return []
    return rows_from_table(eval_scenarios_table(scenarios, seed=seed))
