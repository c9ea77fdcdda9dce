"""The paper's DAG model of S-SGD (Section IV).

A copy of :mod:`repro.core.dag`: a training job is a DAG
``G = (V_c U V_n, E)`` where ``V_c`` are *computing* tasks (per-layer
forward/backward, model update), ``V_n`` are *communication* tasks (disk
I/O, host-to-device copy, per-layer gradient aggregation), and a directed
edge ``(x, y)`` means task ``y`` may only start after ``x`` finishes.
:func:`build_ssgd_dag` reproduces Fig. 1 of the paper for any number of
layers, workers and iterations under an overlap
:class:`~repro_torch.core.policies.Policy`, with the heterogeneous and
failure axes (``worker_scale``, ``sync_k``, ``crashed``, ``restart_s``)
that make the event-driven simulator the sweep's agreement oracle.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Callable, Iterable, Sequence

from repro_torch.core.bucketsim import bucket_partition
from repro_torch.core.policies import Policy


class TaskKind(enum.Enum):
    COMPUTE = "compute"
    COMM = "comm"


# Channel name templates.  The simulator serializes tasks that share a
# channel; distinct channels run in parallel (GPU stream vs. PCIe vs.
# disk vs. the collective network, as in the paper's two task classes).
def gpu_channel(worker: int) -> str:
    return f"gpu:{worker}"


def disk_channel(worker: int) -> str:
    return f"disk:{worker}"


def pcie_channel(worker: int) -> str:
    return f"pcie:{worker}"


NET_CHANNEL = "net"

#: Shared checkpoint-store channel: crash restores read the same npz
#: store (:mod:`repro_torch.checkpoint.ckpt`), so they serialize — which is
#: what makes the per-iteration fault penalty additive in the crash
#: count (see :class:`repro_torch.core.het.FaultSpec`).
CKPT_CHANNEL = "ckpt"


@dataclass
class Task:
    tid: int
    name: str
    kind: TaskKind
    duration: float
    channel: str
    iteration: int = 0
    layer: int | None = None          # 1-based, as in the paper
    worker: int | None = None
    priority: float = 0.0             # lower = scheduled first on channel ties
    nbytes: float = 0.0               # payload for comm tasks


@dataclass
class DAG:
    """Directed acyclic graph of :class:`Task` with precedence edges."""

    tasks: dict[int, Task] = field(default_factory=dict)
    preds: dict[int, set[int]] = field(default_factory=dict)
    succs: dict[int, set[int]] = field(default_factory=dict)
    _next_id: int = 0

    # -- construction ---------------------------------------------------
    def add_task(self, name: str, kind: TaskKind, duration: float, channel: str,
                 **kw) -> int:
        if duration < 0:
            raise ValueError(f"negative duration for task {name}: {duration}")
        tid = self._next_id
        self._next_id += 1
        self.tasks[tid] = Task(tid, name, kind, float(duration), channel, **kw)
        self.preds[tid] = set()
        self.succs[tid] = set()
        return tid

    def add_edge(self, src: int, dst: int) -> None:
        if src == dst:
            raise ValueError("self edge")
        self.preds[dst].add(src)
        self.succs[src].add(dst)

    def add_edges(self, srcs: Iterable[int], dst: int) -> None:
        for s in srcs:
            self.add_edge(s, dst)

    # -- queries ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.tasks)

    def sources(self) -> list[int]:
        return [t for t in self.tasks if not self.preds[t]]

    def sinks(self) -> list[int]:
        return [t for t in self.tasks if not self.succs[t]]

    def topo_order(self) -> list[int]:
        """Kahn topological order; raises if the graph has a cycle."""
        indeg = {t: len(p) for t, p in self.preds.items()}
        ready = sorted([t for t, d in indeg.items() if d == 0])
        order: list[int] = []
        import heapq

        heapq.heapify(ready)
        while ready:
            t = heapq.heappop(ready)
            order.append(t)
            for s in self.succs[t]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    heapq.heappush(ready, s)
        if len(order) != len(self.tasks):
            raise ValueError("DAG contains a cycle")
        return order

    def critical_path(self) -> tuple[float, list[int]]:
        """Makespan with infinite resources (longest path)."""
        finish: dict[int, float] = {}
        best_pred: dict[int, int | None] = {}
        for t in self.topo_order():
            start = 0.0
            bp = None
            for p in self.preds[t]:
                if finish[p] > start:
                    start, bp = finish[p], p
            finish[t] = start + self.tasks[t].duration
            best_pred[t] = bp
        end = max(finish, key=lambda t: finish[t])
        path = [end]
        while best_pred[path[-1]] is not None:
            path.append(best_pred[path[-1]])  # type: ignore[arg-type]
        return finish[end], list(reversed(path))

    def total_work(self) -> float:
        return sum(t.duration for t in self.tasks.values())


@dataclass(frozen=True)
class IterationCosts:
    """Per-iteration task durations feeding the DAG builder.

    This is the paper's Table I vocabulary: ``t_io``, ``t_h2d``,
    layer-wise ``t_f^(l)``, ``t_b^(l)``, ``t_c^(l)`` and ``t_u``.
    Comm durations are for the *collective* across all participating
    workers (layer-wise all-reduce), as measured in the paper's traces.
    """

    t_f: Sequence[float]              # forward, layer 1..L
    t_b: Sequence[float]              # backward, layer 1..L (index 0 = layer 1)
    t_c: Sequence[float]              # gradient all-reduce, layer 1..L
    t_io: float = 0.0
    t_h2d: float = 0.0
    t_u: float = 0.0
    grad_bytes: Sequence[float] | None = None   # per layer, for bucketing

    @property
    def num_layers(self) -> int:
        return len(self.t_f)

    def with_comm(self, t_c: Sequence[float],
                  grad_bytes: Sequence[float] | None = None) -> "IterationCosts":
        """Copy with the per-layer comm durations replaced — used by the
        sweep engine to re-cost the same compute profile under a
        different collective algorithm / interconnect without rebuilding
        the layer tables."""
        return dataclasses.replace(
            self, t_c=list(t_c),
            grad_bytes=self.grad_bytes if grad_bytes is None else list(grad_bytes))

    def __post_init__(self):
        if not (len(self.t_f) == len(self.t_b) == len(self.t_c)):
            raise ValueError("t_f, t_b, t_c must have equal length")
        if self.grad_bytes is not None and len(self.grad_bytes) != len(self.t_f):
            raise ValueError("grad_bytes length mismatch")


def _bucketize(costs: IterationCosts, policy: Policy,
               comm_scale: Callable[[float, float], float] | None) -> list[tuple[str, list[int], float]]:
    """Group layers (in backward order L..1) into communication buckets.

    Returns ``[(name, member_layers, duration)]`` in issue order.  With
    ``policy.bucket_bytes`` unset every learnable layer is its own
    bucket (the paper's layer-wise NCCL pattern).  With bucketing the
    durations are re-derived via ``comm_scale(total_bytes, total_time)``
    when byte sizes are known, else summed.

    Boundaries come from the shared
    :func:`repro_torch.core.bucketsim.bucket_partition` — the one boundary
    rule this builder and the batched timeline kernel both consume, so
    the event-driven oracle and the batched path can never drift.
    """
    if not policy.bucket_bytes:
        return [(f"comm_l{m + 1}", [m], costs.t_c[m])
                for [m] in bucket_partition(
                    [c > 0 for c in costs.t_c], None, None)]

    buckets: list[tuple[str, list[int], float]] = []
    for members in bucket_partition([c > 0 for c in costs.t_c],
                                    costs.grad_bytes, policy.bucket_bytes):
        cur_time = sum(costs.t_c[m] for m in members)
        cur_bytes = sum(costs.grad_bytes[m] for m in members) \
            if costs.grad_bytes is not None else 0.0
        dur = comm_scale(cur_bytes, cur_time) \
            if (comm_scale and cur_bytes) else cur_time
        buckets.append((f"comm_bucket{len(buckets)}", members, dur))
    return buckets


class SSGDDagBuilder:
    """Incremental Fig.-1 DAG construction, one iteration at a time.

    Holds the cross-iteration state (the previous update and H2D
    tasks) so callers can interleave :meth:`add_iteration` with
    incremental simulation — this is what lets
    :func:`repro_torch.core.simulator.simulate_steady` stop building as soon
    as the update-task deltas converge instead of always paying the
    full warm-up cap.  :func:`build_ssgd_dag` wraps it for the common
    build-everything-up-front case.
    """

    def __init__(self, costs: IterationCosts, n_workers: int, policy: Policy,
                 comm_scale: Callable[[float, float], float] | None = None,
                 shared_compute: bool = False,
                 worker_scale: Sequence[float] | None = None,
                 sync_k: int | None = None,
                 crashed: Sequence[int] = (),
                 restart_s: float = 0.0):
        if n_workers < 1:
            raise ValueError("n_workers >= 1")
        if restart_s < 0:
            raise ValueError("restart_s must be >= 0")
        if worker_scale is not None:
            worker_scale = [float(s) for s in worker_scale]
            if len(worker_scale) != n_workers:
                raise ValueError(
                    f"worker_scale must have one entry per worker "
                    f"({n_workers}), got {len(worker_scale)}")
            if any(s <= 0 for s in worker_scale):
                raise ValueError("worker_scale entries must be > 0")
        self.dag = DAG()
        self.costs = costs
        self.n_workers = n_workers
        self.policy = policy
        self.n_iterations = 0
        # Per-worker compute-time multipliers (heterogeneous GPUs /
        # straggler jitter): worker ``w``'s forward and backward tasks
        # run ``worker_scale[w]`` x slower.  I/O, H2D, comm and the
        # update are deliberately unscaled — they live on their own
        # channels (disk/PCIe/net) or are HBM-bound (t_u).
        self._worker_scale = worker_scale
        # ``shared_compute`` serializes all workers on one compute
        # channel — models host-device oversubscription (N logical
        # devices on one core), used by the §V-D validation
        # (repro_torch.examples.dag_validation).
        self._gpu_of = (lambda w: "gpu:shared") if shared_compute \
            else gpu_channel
        # bucket boundaries depend only on (costs, policy, comm_scale)
        self._buckets = _bucketize(costs, policy, comm_scale) \
            if n_workers > 1 else []
        # K-of-N partial synchronization: the aggregation and the model
        # update gate on the K *fastest* workers only (smallest
        # compute multiplier, ties broken by worker index — exactly the
        # K-th order statistic the closed form takes).  ``None`` keeps
        # the full-sync edge set bit-identical to the historical path.
        keff = n_workers if not sync_k or int(sync_k) <= 0 \
            else min(int(sync_k), n_workers)
        if keff < n_workers:
            ws = worker_scale if worker_scale is not None \
                else [1.0] * n_workers
            order = sorted(range(n_workers), key=lambda w: (ws[w], w))
            self._sync_workers: list[int] | None = sorted(order[:keff])
        else:
            self._sync_workers = None
        # Crash/recover events: each worker in ``crashed`` loses its
        # state every iteration and re-reads the checkpoint
        # (``restart_s`` seconds on the shared CKPT_CHANNEL) before the
        # model update may broadcast.
        self._crashed = sorted({int(w) for w in crashed})
        if any(w < 0 or w >= n_workers for w in self._crashed):
            raise ValueError("crashed worker index out of range")
        self._restart_s = float(restart_s)
        self._prev_update: int | None = None
        self._prev_h2d: list[int] = []

    def add_iteration(self) -> int:
        """Append one iteration's tasks and edges; returns the
        iteration's ``update`` task id."""
        g, costs, policy = self.dag, self.costs, self.policy
        L = costs.num_layers
        it = self.n_iterations
        prev_update, prev_h2d = self._prev_update, self._prev_h2d

        # --- I/O + H2D (communication tasks T0-T7 in Fig. 1) -----------
        h2d_tasks = []
        for w in range(self.n_workers):
            io = g.add_task(f"io_w{w}", TaskKind.COMM, costs.t_io,
                            disk_channel(w), iteration=it, worker=w)
            # Overlapped I/O: next fetch only waits for the previous fetch
            # (disk channel); otherwise it waits for the previous update.
            if prev_update is not None and not policy.overlap_io:
                g.add_edge(prev_update, io)
            if prev_h2d:
                # Single staging buffer: the next fetch reuses the buffer
                # freed by the previous upload, so the prefetch stage has
                # period t_io + t_h2d — exactly the paper's Eq. (3)/(5)
                # term max(t_io + t_h2d, ...).
                g.add_edge(prev_h2d[w], io)
            h2d = g.add_task(f"h2d_w{w}", TaskKind.COMM, costs.t_h2d,
                             pcie_channel(w), iteration=it, worker=w)
            g.add_edge(io, h2d)
            # Early H2D (Caffe-MPI's GPU-side buffer) starts right after its
            # fetch; otherwise it must wait for the previous model update
            # (no spare device buffer to write into).
            if prev_update is not None and not policy.h2d_early:
                g.add_edge(prev_update, h2d)
            if prev_h2d:
                g.add_edge(prev_h2d[w], h2d)
            h2d_tasks.append(h2d)

        # --- forward, layer 1..L ---------------------------------------
        scale = self._worker_scale
        fwd: list[list[int]] = [[] for _ in range(L)]
        for w in range(self.n_workers):
            ws = 1.0 if scale is None else scale[w]
            prev = h2d_tasks[w]
            for l in range(L):
                t = g.add_task(f"fwd_l{l + 1}_w{w}", TaskKind.COMPUTE,
                               costs.t_f[l] * ws, self._gpu_of(w),
                               iteration=it,
                               layer=l + 1, worker=w, priority=float(l))
                g.add_edge(prev, t)
                if l == 0 and prev_update is not None:
                    g.add_edge(prev_update, t)
                fwd[l].append(t)
                prev = t

        # --- backward, layer L..1 --------------------------------------
        bwd: dict[int, list[int]] = {}
        for w in range(self.n_workers):
            ws = 1.0 if scale is None else scale[w]
            prev = fwd[L - 1][w]
            for l in range(L - 1, -1, -1):
                t = g.add_task(f"bwd_l{l + 1}_w{w}", TaskKind.COMPUTE,
                               costs.t_b[l] * ws, self._gpu_of(w),
                               iteration=it,
                               layer=l + 1, worker=w,
                               priority=float(2 * L - l))
                g.add_edge(prev, t)
                bwd.setdefault(l, []).append(t)
                prev = t
        last_bwd = [bwd[0][w] for w in range(self.n_workers)]  # layer 1 last
        # Partial sync: only the K participants' gradients gate the
        # aggregation and the update.  Non-participants keep training
        # (their tasks still occupy their own channels) but nothing
        # downstream waits for them.
        sync = self._sync_workers
        sync_last_bwd = last_bwd if sync is None \
            else [last_bwd[w] for w in sync]

        # --- gradient aggregation (comm tasks T32-T34) -----------------
        comm_tasks: list[int] = []
        prev_comm: int | None = None
        for bname, members, dur in self._buckets:
            # ByteScheduler semantics (policies.py): priority is the
            # bucket's earliest layer — layer-1/earlier-needed
            # tensors overtake on a priority-scheduled net channel
            # (lower value = scheduled first).  ``members`` is in
            # backward order, so the earliest layer is members[-1].
            c = g.add_task(bname, TaskKind.COMM, dur, NET_CHANNEL,
                           iteration=it, layer=members[0] + 1,
                           priority=float(members[-1]),
                           nbytes=sum(costs.grad_bytes[m] for m in members)
                           if costs.grad_bytes is not None else 0.0)
            if policy.overlap_comm:
                # WFBP: ready as soon as every participating worker
                # finished the backward of every member layer.
                for m in members:
                    g.add_edges(bwd[m] if sync is None
                                else [bwd[m][w] for w in sync], c)
            else:
                # CNTK: aggregation only after the entire backward pass.
                g.add_edges(sync_last_bwd, c)
            if prev_comm is not None and policy.serialize_comm:
                g.add_edge(prev_comm, c)
            prev_comm = c
            comm_tasks.append(c)

        # --- checkpoint restores (crash/recover events) ----------------
        # A crashed worker re-reads the checkpoint before the update may
        # broadcast.  Restores gate on the same predecessors the update
        # would (the sync point is where the crash is detected) and
        # chain on the shared checkpoint store, so an iteration with
        # ``c`` crashes finishes exactly ``c * restart_s`` later.
        restores: list[int] = []
        for w in self._crashed:
            r = g.add_task(f"restore_w{w}", TaskKind.COMM,
                           self._restart_s, CKPT_CHANNEL, iteration=it,
                           worker=w, priority=float(3 * L))
            g.add_edges(sync_last_bwd, r)
            g.add_edges(comm_tasks, r)
            if restores:
                g.add_edge(restores[-1], r)
            restores.append(r)

        # --- model update (T35) ----------------------------------------
        # The update runs on a *participant's* GPU stream: under K-of-N
        # a non-participant straggler keeps its own channel busy past
        # the sync point, and parking the update there would serialize
        # the whole pipeline behind a worker nobody waits for.
        upd = g.add_task("update", TaskKind.COMPUTE, costs.t_u,
                         self._gpu_of(0 if sync is None else sync[0]),
                         iteration=it, priority=float(3 * L + 1))
        g.add_edges(sync_last_bwd, upd)
        g.add_edges(comm_tasks, upd)
        g.add_edges(restores, upd)
        self._prev_update = upd
        self._prev_h2d = h2d_tasks
        self.n_iterations += 1
        return upd


def build_ssgd_dag(
    costs: IterationCosts,
    n_workers: int,
    policy: Policy,
    n_iterations: int = 1,
    comm_scale: Callable[[float, float], float] | None = None,
    shared_compute: bool = False,
    worker_scale: Sequence[float] | None = None,
    sync_k: int | None = None,
    crashed: Sequence[int] = (),
    restart_s: float = 0.0,
) -> DAG:
    """Build the S-SGD DAG of Fig. 1 for ``n_iterations`` iterations.

    Single-GPU training (``n_workers == 1``) degenerates to Eq. (1):
    the comm tasks get zero duration and the graph is a chain.

    ``comm_scale(total_bytes, naive_total_time)`` maps a fused bucket to
    its collective duration (used by the bucketing policy to model the
    latency amortization the paper calls for in §VII).
    ``worker_scale`` gives per-worker compute-time multipliers
    (heterogeneous GPUs / straggler jitter draws) — the per-worker DAG
    is the agreement oracle for the heterogeneous batched engine.
    ``sync_k`` enables K-of-N partial synchronization (``None``/``0`` =
    full sync); ``crashed`` workers pay a serialized ``restart_s``
    checkpoint restore before each iteration's update.
    """
    b = SSGDDagBuilder(costs, n_workers, policy, comm_scale=comm_scale,
                       shared_compute=shared_compute,
                       worker_scale=worker_scale, sync_k=sync_k,
                       crashed=crashed, restart_s=restart_s)
    for _ in range(n_iterations):
        b.add_iteration()
    return b.dag
