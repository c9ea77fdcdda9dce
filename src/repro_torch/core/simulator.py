"""Event-driven list scheduler for the S-SGD DAG.

A copy of :mod:`repro.core.simulator`.  It executes a
:class:`repro_torch.core.dag.DAG` under *resource constraints*: each
channel (GPU stream per worker, disk, PCIe, collective network) runs one
task at a time.  This is what turns the paper's Fig. 1 precedence graph
into an iteration-time prediction.

The scheduler is a **global event heap** over per-channel candidates:
each channel keeps its ready queue, and whenever the queue or the
channel's free time changes, its current best candidate (start time,
queue key) is pushed onto one shared heap with a per-channel version
stamp; stale entries are discarded on pop.

:class:`Simulation` is incremental: tasks appended to the DAG after a
completed :meth:`~Simulation.run` are picked up by
:meth:`~Simulation.extend`, which lets :func:`simulate_policy` grow the
DAG one iteration at a time and stop once the steady state is reached.

Left out, as in :mod:`repro_torch.core.dag`: the heterogeneous and
failure arguments of ``simulate_policy`` / ``simulate_steady`` and the
schedule views ``SimResult.tasks_on`` / ``timeline``.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Callable

from repro_torch.core.dag import (DAG, NET_CHANNEL, IterationCosts, SSGDDagBuilder,
                                  Task)

#: Relative tolerance for steady-state detection: two consecutive
#: update-delta pairs must agree this tightly before the warm-up loop
#: stops early.
STEADY_RTOL = 1e-9


@dataclass(frozen=True)
class ScheduledTask:
    task: Task
    start: float
    finish: float


@dataclass
class SimResult:
    makespan: float
    schedule: dict[int, ScheduledTask]
    channel_busy: dict[str, float]
    #: Iterations actually simulated by :func:`simulate_policy` (where an
    #: ``auto_steady`` warm-up converged); ``None`` for :func:`simulate`.
    n_iterations_used: int | None = None

    def utilization(self, channel: str) -> float:
        return self.channel_busy.get(channel, 0.0) / self.makespan if self.makespan else 0.0

    def iteration_times(self) -> list[float]:
        """Finish time of each iteration's update task (cumulative)."""
        ups = sorted((s for s in self.schedule.values() if s.task.name == "update"),
                     key=lambda s: s.task.iteration)
        return [s.finish for s in ups]

    def steady_iteration_time(self) -> float:
        """Per-iteration time once the pipeline is warm (last iter delta).

        Raises ``ValueError`` when the schedule contains no ``update``
        task.
        """
        it = self.iteration_times()
        if not it:
            raise ValueError(
                "schedule contains no 'update' task (was the DAG built "
                "with n_iterations=0, or without an update node?); "
                "steady-state iteration time is undefined")
        if len(it) == 1:
            return it[0]
        return it[-1] - it[-2]


class Simulation:
    """Incremental list scheduler over a (possibly growing) DAG.

    Tasks become *ready* when all predecessors finished; each channel
    executes ready tasks one at a time.  Ready tasks on the same channel
    are ordered by (ready_time, priority, tid) unless the channel is in
    ``priority_channels``, in which case the channel takes, each time it
    frees up, the smallest-``priority`` task among those already ready
    (work-conserving priority queueing).
    """

    def __init__(self, dag: DAG,
                 priority_channels: frozenset[str] | None = None):
        self.dag = dag
        self.priority_channels = priority_channels or frozenset()
        self.schedule: dict[int, ScheduledTask] = {}
        self.channel_busy: dict[str, float] = {}
        self._queues: dict[str, list] = {}
        self._channel_free: dict[str, float] = {}
        self._version: dict[str, int] = {}
        self._heap: list = []
        self._indeg: dict[int, int] = {}
        self._ready_time: dict[int, float] = {}
        self._ingested = 0                  # tids are dense and ordered
        self._n_done = 0
        self.extend()

    def _push(self, tid: int, at: float) -> None:
        ch = self.dag.tasks[tid].channel
        prio = self.dag.tasks[tid].priority
        q = self._queues.setdefault(ch, [])
        self._channel_free.setdefault(ch, 0.0)
        self._version.setdefault(ch, 0)
        if ch in self.priority_channels:
            q.append((prio, at, tid))
        else:
            heapq.heappush(q, ((at, prio, tid), tid))

    def extend(self) -> int:
        """Ingest tasks appended to the DAG since the last call;
        returns how many were picked up."""
        new = range(self._ingested, self.dag._next_id)
        touched = set()
        for tid in new:
            preds = self.dag.preds[tid]
            ready = 0.0
            pending = 0
            for p in preds:
                done = self.schedule.get(p)
                if done is None:
                    pending += 1
                elif done.finish > ready:
                    ready = done.finish
            self._indeg[tid] = pending
            self._ready_time[tid] = ready
            if pending == 0:
                self._push(tid, ready)
                touched.add(self.dag.tasks[tid].channel)
        self._ingested = self.dag._next_id
        for ch in touched:
            self._push_candidate(ch)
        return len(new)

    def _push_candidate(self, ch: str) -> None:
        """(Re)announce ``ch``'s best next task on the global heap,
        stamped with the channel's version."""
        q = self._queues.get(ch)
        self._version[ch] = self._version.get(ch, 0) + 1
        if not q:
            return
        if ch in self.priority_channels:
            # earliest instant the channel can start anything...
            start = max(self._channel_free[ch], min(r for _, r, _ in q))
            # ...and the best priority among tasks ready by then
            item = min(it for it in q if it[1] <= start)
            key, tid = item, item[2]
        else:
            key, tid = q[0]
            start = max(self._channel_free[ch], self._ready_time[tid])
            item = None
        heapq.heappush(self._heap,
                       (start, key, ch, self._version[ch], tid, item))

    def run(self) -> None:
        """Schedule every ingested task; safe to call repeatedly as the
        DAG grows (see :meth:`extend`)."""
        dag = self.dag
        while self._n_done < self._ingested:
            if not self._heap:
                raise RuntimeError(
                    "deadlock: no ready task but DAG not done (cycle?)")
            start, key, ch, ver, tid, item = heapq.heappop(self._heap)
            if ver != self._version[ch]:
                continue                     # stale candidate
            if ch in self.priority_channels:
                self._queues[ch].remove(item)
            else:
                heapq.heappop(self._queues[ch])
            task = dag.tasks[tid]
            finish = start + task.duration
            self.schedule[tid] = ScheduledTask(task, start, finish)
            self._channel_free[ch] = finish
            self.channel_busy[ch] = \
                self.channel_busy.get(ch, 0.0) + task.duration
            self._n_done += 1
            touched = {ch}
            for s in dag.succs[tid]:
                self._indeg[s] -= 1
                if finish > self._ready_time[s]:
                    self._ready_time[s] = finish
                if self._indeg[s] == 0:
                    self._push(s, self._ready_time[s])
                    touched.add(dag.tasks[s].channel)
            for c2 in touched:
                self._push_candidate(c2)

    def result(self) -> SimResult:
        makespan = max((s.finish for s in self.schedule.values()),
                       default=0.0)
        return SimResult(makespan, self.schedule, self.channel_busy)


def simulate(dag: DAG, priority_channels: frozenset[str] | None = None) -> SimResult:
    """List-schedule ``dag`` on constrained channels (one shot)."""
    sim = Simulation(dag, priority_channels=priority_channels)
    sim.run()
    return sim.result()


def _steady_converged(finishes: list[float], rtol: float) -> bool:
    """True once the last two update-interval deltas agree (pairwise,
    within ``rtol`` of their magnitude)."""
    if len(finishes) < 4:
        return False
    d = [finishes[-1] - finishes[-2], finishes[-2] - finishes[-3],
         finishes[-3] - finishes[-4]]
    scale = max(abs(x) for x in d)
    if scale == 0.0:
        return True
    return (abs(d[0] - d[1]) <= rtol * scale
            and abs(d[1] - d[2]) <= rtol * scale)


def simulate_policy(
    costs: IterationCosts,
    n_workers: int,
    policy,
    n_iterations: int = 6,
    comm_scale: Callable[[float, float], float] | None = None,
    auto_steady: bool = False,
    rtol: float = STEADY_RTOL,
) -> SimResult:
    """Build the Fig.-1 S-SGD DAG for ``policy`` and list-schedule it;
    ``policy.priority_comm`` puts the collective channel in
    priority-scheduling mode.  With ``auto_steady=True`` the DAG grows one
    iteration at a time and the warm-up stops once the update-task deltas
    converge (``rtol``), capped at ``n_iterations``;
    :attr:`SimResult.n_iterations_used` records where it stopped."""
    builder = SSGDDagBuilder(costs, n_workers, policy, comm_scale=comm_scale)
    prio = frozenset([NET_CHANNEL]) if getattr(policy, "priority_comm", False) \
        else None
    sim = Simulation(builder.dag, priority_channels=prio)
    finishes: list[float] = []
    for _ in range(n_iterations):
        upd = builder.add_iteration()
        sim.extend()
        sim.run()
        finishes.append(sim.schedule[upd].finish)
        if auto_steady and _steady_converged(finishes, rtol):
            break
    res = sim.result()
    res.n_iterations_used = builder.n_iterations
    return res


def simulate_steady(
    costs: IterationCosts,
    n_workers: int,
    policy,
    n_iterations: int = 6,
    comm_scale: Callable[[float, float], float] | None = None,
) -> float:
    """:func:`simulate_policy`, reduced to the warm per-iteration time in
    seconds, with the steady state detected (``n_iterations`` the cap)."""
    return simulate_policy(costs, n_workers, policy, n_iterations,
                           comm_scale, auto_steady=True) \
        .steady_iteration_time()
