"""Bucket-timeline steady state: the schedule-dependent policies, closed.

A copy of :mod:`repro.core.bucketsim`; :func:`timeline_residual` is
polymorphic over NumPy and torch (:mod:`repro_torch.core.xputil`).

The sweep engine's two "inexact" policies — gradient-bucket fusion
(``bucketed-*``) and priority comm scheduling (``priority``) — used to
be simulator-only: their comm schedule depends on the schedule itself,
so no *per-layer* closed form exists.  But their **steady state** does
have an exact closed form, because the collective network is a single
work-conserving channel:

* Iterations cannot overlap on the net channel (iteration *k*'s update
  precedes iteration *k+1*'s forward, which precedes its backward,
  which releases its comm), so each iteration's comm schedule starts on
  an idle channel.
* On a single non-idling channel the **finish time of the last task is
  order-independent**: the backlog ``arrived(t) - completed(t)`` evolves
  identically for every work-conserving order, and the channel is busy
  exactly while the backlog is positive.  FIFO bucket chains and
  ByteScheduler-style priority reordering therefore release the model
  update at the same instant (priority still changes *which* tensor
  lands first — that matters for cross-iteration schedules the DAG
  model does not express — but not the steady iteration time).

So with buckets ``j = 0..B-1`` in issue order (backward layer order),
release times ``r_j`` (the backward finish of the bucket's earliest
layer under WFBP, or the full backward time without comm overlap) and
durations ``d_j`` (one collective over the bucket's summed payload),
the channel finishes at

    makespan = max_j ( r_j + sum_{j' >= j} d_j' )

and the residual the GPU chain cannot hide is
``max(makespan - sum(t_b), 0)`` — exactly the prefix/suffix-sum shape
of :func:`repro_torch.core.analytical.non_overlapped_comm_batch`, with
buckets in place of layers.  ``tests/test_bucketsim.py`` pins this
against :func:`repro_torch.core.simulator.simulate_steady` to <= 1e-6
relative on every built-in grid (and much tighter on synthetic costs);
``force_simulator=True`` keeps the event-driven path available as the
agreement oracle.

This module holds the pure kernel: bucket structure tables (padded
``(W, B)`` per workload axis, mirroring :func:`repro_torch.core.dag._bucketize`
boundaries exactly) and the vectorized ``(S, B)`` residual.  The
wiring — collective-model durations, policy select, grid routing —
lives in :mod:`repro_torch.core.batched`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def bucket_partition(comm_mask, payload,
                     bucket_bytes: float | None) -> list[list[int]]:
    """**The** bucket-boundary rule, shared by the DAG builder
    (:func:`repro_torch.core.dag._bucketize`) and the batched timeline kernel
    so the two paths can never disagree on where buckets fall.

    Returns member-layer lists (each in backward order) in issue
    order: layers are visited backward (layer L first), layers with a
    falsy ``comm_mask`` entry are skipped (they produce no comm task),
    and a bucket flushes once its accumulated ``payload`` reaches
    ``bucket_bytes`` — the trailing partial bucket flushes at the end.
    ``bucket_bytes=None`` degenerates to one bucket per comm layer
    (the per-layer pattern the ``priority`` policy schedules);
    ``payload=None`` (byte sizes unknown) never flushes early, i.e.
    one bucket spanning every comm layer.
    """
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0.0
    for layer in range(len(comm_mask) - 1, -1, -1):
        if not comm_mask[layer]:
            continue
        cur.append(layer)
        if payload is not None:
            cur_bytes += payload[layer]
        if bucket_bytes is None or \
                (payload is not None and cur_bytes >= bucket_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0.0
    if cur:
        buckets.append(cur)
    return buckets


def bucket_layers(grad_bytes, bucket_bytes: float | None) -> list[tuple[float, int]]:
    """``[(payload_bytes, release_layer)]`` in issue order for one
    workload's per-layer gradient payloads.

    A layer carries a comm task iff its payload is positive — the same
    predicate :meth:`~repro_torch.core.workloads.WorkloadTable.iteration_costs`
    uses to zero ``t_c``, so this matches the DAG builder's ``t_c > 0``
    membership on every table the batched path evaluates; the
    boundaries themselves come from the shared
    :func:`bucket_partition`.  ``release_layer`` is the forward index
    of the bucket's *earliest* (= last-flushed) member: under WFBP the
    bucket is released when that layer's backward finishes.
    """
    grad_bytes = np.asarray(grad_bytes, dtype=np.float64)
    return [(float(sum(grad_bytes[m] for m in members)), members[-1])
            for members in bucket_partition(grad_bytes > 0, grad_bytes,
                                            bucket_bytes)]


@dataclass(frozen=True)
class BucketTable:
    """Padded bucket structure for a workload axis at one bucket size.

    ``(W, B_max)`` arrays, one row per workload; padding buckets have
    ``nbytes = 0``, ``release_layer = 0`` and ``mask = False`` — they
    contribute no duration and are excluded from the makespan max, so
    workloads with different bucket counts share one table (the same
    zero-padding contract as the batched layer tables).
    """

    nbytes: np.ndarray            # (W, B) summed gradient payload
    release_layer: np.ndarray     # (W, B) int64 forward index, 0 on padding
    mask: np.ndarray              # (W, B) bool, False on padding

    @property
    def n_buckets(self) -> int:
        return self.nbytes.shape[1]


def bucket_table(grad_bytes: np.ndarray, bucket_bytes: float | None) -> BucketTable:
    """Bucket structure for a padded ``(W, L)`` gradient-payload matrix
    (the batched evaluator's workload axis) at one bucket size."""
    rows = [bucket_layers(g, bucket_bytes) for g in np.atleast_2d(grad_bytes)]
    bmax = max((len(r) for r in rows), default=0) or 1
    W = len(rows)
    nbytes = np.zeros((W, bmax))
    release = np.zeros((W, bmax), dtype=np.int64)
    mask = np.zeros((W, bmax), dtype=bool)
    for i, r in enumerate(rows):
        for j, (b, lmin) in enumerate(r):
            nbytes[i, j] = b
            release[i, j] = lmin
            mask[i, j] = True
    return BucketTable(nbytes=nbytes, release_layer=release, mask=mask)


def suffix_tables(bt: BucketTable) -> tuple[np.ndarray, np.ndarray]:
    """``(suffix_nbytes, suffix_count)``: inclusive suffix sums over
    issue order of bucket payload bytes and live-bucket counts, both
    ``(W, B)`` float64.

    With an affine collective model ``d_j = per_byte * nbytes_j +
    per_message`` (zero on padding), the duration suffix sum inside
    :func:`timeline_residual` collapses to ``per_byte * suffix_nbytes +
    per_message * suffix_count`` — no per-point ``(S, B)`` duration
    matrix, no cumsum.  Shared by both batched backends
    (:mod:`repro_torch.core.batched`, :mod:`repro_torch.core.batched_torch`)."""
    sufnb = np.flip(np.cumsum(np.flip(bt.nbytes, -1), -1), -1)
    sufcnt = np.flip(np.cumsum(np.flip(
        bt.mask.astype(np.float64), -1), -1), -1)
    return sufnb, sufcnt


def timeline_residual(t_b: np.ndarray, durations: np.ndarray,
                      release_layer: np.ndarray, mask: np.ndarray,
                      overlap_comm: bool = True) -> np.ndarray:
    """The communication residual of the bucket timeline, vectorized
    over ``(scenario, bucket)`` matrices.

    ``t_b`` is ``(..., L)`` backward times in forward layer order (zero
    padding allowed); ``durations`` / ``release_layer`` / ``mask`` are
    ``(..., B)`` bucket matrices in issue order, layer/bucket axes
    last — ``(S, L)``/``(S, B)`` matrices or single ``(L,)``/``(B,)``
    rows, NumPy arrays or torch tensors (dtype-polymorphic).  With ``overlap_comm`` a bucket is released at the
    inclusive backward suffix sum of its ``release_layer`` (WFBP);
    without it every bucket releases when the whole backward pass
    finishes (comm-at-end).  Returns the ``(...,)`` residual
    ``max(makespan - sum(t_b), 0)`` that joins the GPU chain in place
    of the per-layer WFBP term ``t_c^no``.

    Degenerate shapes fall out of the formula: one giant bucket whose
    release layer is the first comm layer reproduces comm-at-end; one
    bucket per layer reproduces
    :func:`repro_torch.core.analytical.non_overlapped_comm_batch` exactly
    (property-tested).
    """
    from repro_torch.core.xputil import array_namespace, max_or_zero

    xp = array_namespace(t_b, durations, release_layer)
    t_b = xp.asarray(t_b, dtype=xp.float64)
    durations = xp.asarray(durations, dtype=xp.float64) * mask
    prefix_b = xp.cumsum(t_b, axis=-1)
    total_b = prefix_b[..., -1]
    if overlap_comm:
        suffix_b = (total_b[..., None] - prefix_b) + t_b  # inclusive suffix
        release = xp.take_along_axis(suffix_b, release_layer, axis=-1)
    else:
        release = xp.broadcast_to(total_b[..., None], durations.shape)
    # duration suffix sum over issue order: bucket j waits for nothing
    # issued after it, but everything issued at-or-after j must run
    # before the channel drains past j's contribution
    sufdur = xp.flip(xp.cumsum(xp.flip(durations, axis=-1), axis=-1), axis=-1)
    cand = (release + sufdur) * mask      # mask-multiply: padding -> 0
    makespan = max_or_zero(cand, -1)
    return xp.maximum(makespan - total_b, 0.0)
