"""Scenario sweep of the S-SGD DAG model: the port's counterpart of
:mod:`repro.core.sweep`.

Evaluates a :class:`~repro_torch.core.scenarios.ScenarioGrid` (or a list
of scenarios) — ``(workload x cluster x workers x interconnect x policy x
collective x het x straggler x sync_k x faults)`` — and returns the
reference's tidy columnar table (:data:`COLUMNS`) with its
``n_analytical`` / ``n_timeline`` / ``n_simulated`` accounting.  Two
backends:

* ``backend="torch"`` (the default): the batched kernel's two tiers on
  the card in float64 (:mod:`repro_torch.core.batched_torch`); ``device``
  is CUDA unless ``"cpu"`` is asked for, and asking for CUDA without a GPU
  raises.  It is the batched kernel and nothing else: ``batched=False``,
  ``force_simulator=True`` and grids holding a policy with neither batched
  form raise ``ValueError``, as the reference's ``backend="jax"`` does —
  nothing falls back to the host.  ``jobs > 1`` is a no-op on it (one card
  has nothing to shard over, as the reference's jax backend on one device).
* ``backend="numpy"``: the reference's engine bit for bit — the batched
  NumPy kernel (:mod:`repro_torch.core.batched`) for closed-form
  (``method="analytical"``) and bucket-timeline (``method="timeline"``)
  policies, the event-driven simulator
  (:func:`repro_torch.core.simulator.simulate_steady` on the Fig.-1 DAG)
  for the rest and for ``force_simulator=True`` (the agreement oracle),
  the per-scenario reference paths under ``batched=False``, and
  ``jobs=N`` sharding over a worker pool (:mod:`repro_torch.core.parallel`,
  bit-identical to serial).

Results are columnar end to end: :func:`iter_tables` yields them chunk by
chunk, :class:`SweepResult` stores the column arrays, and
:func:`iter_rows` / :func:`stream_csv` / :func:`stream_json` evaluate grids
too big to buffer lazily.
"""
from __future__ import annotations

import csv
import json
import os
import time
from dataclasses import dataclass, field, replace
from typing import Iterable, Iterator, Sequence

import numpy as np

from repro_torch.core import analytical
from repro_torch.core import het as het_mod
from repro_torch.core.batched import eval_scenarios, grid_evaluator
from repro_torch.core.costmodel import comm_scale_fn
from repro_torch.core.policies import Policy
from repro_torch.core.resulttable import (COLUMNS, concat_tables, fill_rows,
                                          method_counts, rows_from_table,
                                          table_from_rows, table_len)
from repro_torch.core.scenarios import (Scenario, ScenarioGrid,
                                        normalize_interconnect,
                                        normalize_sync_k, resolve_cluster,
                                        resolve_policy)
from repro_torch.core.simulator import simulate_steady
from repro_torch.core.workloads import WorkloadTable, resolve_workload


def has_fast_path(policy: Policy) -> bool:
    """True when the policy's steady state has an exact closed form
    (delegates to the single source of truth,
    :func:`repro_torch.core.analytical.has_closed_form`)."""
    return analytical.has_closed_form(policy)


def has_batched_path(policy: Policy) -> bool:
    """True when the policy can be evaluated by the batched kernel at
    all: an exact per-layer closed form (``method="analytical"``) or
    the bucket-timeline form (``method="timeline"``).  Everything else
    — and every scenario under ``force_simulator=True`` — goes through
    the event-driven simulator."""
    return analytical.has_closed_form(policy) \
        or analytical.has_timeline_form(policy)


def _scenario_costs(s: Scenario, tab: WorkloadTable):
    """(costs, cluster, policy, batch) for one scenario, through the
    single construction path every workload provider shares
    (:meth:`repro_torch.core.workloads.WorkloadTable.iteration_costs`)."""
    cluster = resolve_cluster(s)
    policy = resolve_policy(s)
    batch = s.batch_per_gpu or tab.batch_default
    costs = tab.iteration_costs(cluster, batch, s.n_workers, s.collective)
    return costs, cluster, policy, batch


def _scale_compute(costs, tmul: float):
    """Slowest-worker theorem applied to :class:`IterationCosts`: the
    synchronous steady state with per-worker compute multipliers equals
    the homogeneous closed form with ``t_f``/``t_b`` scaled by the
    bottleneck multiplier (``t_io``/``t_h2d``/``t_c``/``t_u`` are not
    compute-rate-bound and stay put)."""
    return replace(costs, t_f=np.asarray(costs.t_f) * tmul,
                   t_b=np.asarray(costs.t_b) * tmul)


def _het_state(s: Scenario):
    """``(inv_speed | None, StragglerSpec | None)`` for one scenario —
    the per-worker compute-rate vector (``None`` when homogeneous, so
    the deterministic path stays bit-identical) and the parsed
    straggler spec."""
    profile = het_mod.parse_het_profile(s.het)
    inv = None
    if profile is not None:
        inv, _, _ = het_mod.worker_vectors(profile, s.n_workers)
    return inv, het_mod.parse_straggler(s.straggler)


def _kth_tmul(times: np.ndarray, sync_k: int) -> np.ndarray:
    """Per-draw bottleneck multiplier under K-of-N partial sync: the
    K-th smallest of each row of per-worker times (``sync_k = 0`` means
    full sync, the max).  ``times`` is ``(D, n)``; clamping keeps
    ``K >= n`` bit-identical to the historical max reduction."""
    n = times.shape[-1]
    keff = n if sync_k == 0 else min(max(int(sync_k), 1), n)
    if keff >= n:
        return times.max(axis=-1)
    return np.partition(times, keff - 1, axis=-1)[..., keff - 1]


def _fault_state(s: Scenario, seed: int, draws: int | None):
    """``(FaultSpec | None, crash_matrix | None)``: the parsed fault
    spec and, when stochastic, the seed-keyed ``(D, n)`` boolean crash
    matrix — each crashed worker costs a serialized ``restart``-second
    checkpoint restore gating the update broadcast (see
    :class:`repro_torch.core.dag.SSGDDagBuilder`)."""
    ft = het_mod.parse_fault(s.faults)
    if ft is None or ft.is_deterministic:
        return ft, None
    return ft, ft.crash_matrix(s.n_workers, seed, draws=draws)


def _ref_tails(t_iters) -> tuple[float, float, float]:
    """``(mean, p95, p99)`` of per-draw iteration times — the same
    host-side reduction the batched Monte Carlo pass applies."""
    t = np.asarray(t_iters)
    return (float(t.mean()), float(np.quantile(t, 0.95)),
            float(np.quantile(t, 0.99)))


def _fast_eval(s: Scenario, seed: int = 0) -> dict:
    """Per-scenario analytical path: NumPy arrays over the layer
    dimension fed straight into the shared closed forms (the scalar
    equations in :mod:`repro_torch.core.analytical` are pure arithmetic over
    sequences, so array-valued ``IterationCosts`` evaluate directly —
    no parallel formula implementation to keep in lockstep).

    Heterogeneous scenarios apply the slowest-worker reduction: links
    are derated in :func:`repro_torch.core.scenarios.resolve_cluster`,
    compute by :func:`_scale_compute` at ``max_w(1/speed_w)``.
    Stochastic stragglers loop the closed form over the Monte Carlo
    draws for the tail columns (same draw matrices as the batched
    engines, keyed by ``seed``).

    This is the **reference implementation and agreement oracle** for
    the scenario-axis batched kernel (:mod:`repro_torch.core.batched`), which
    is what :func:`sweep` actually routes closed-form scenarios
    through; the property tests pin the two to <= 1e-9 relative.

    The failure model folds in exactly as in the batched engine:
    ``sync_k`` swaps the bottleneck max for the K-th order statistic
    (:func:`_kth_tmul`), and a stochastic fault spec adds each draw's
    serialized restore penalty to ``t_u`` — the restores gate the
    update broadcast, so the penalty rides the GPU/update chain
    *inside* the pipeline max."""
    costs0, _, policy, batch = _scenario_costs(s, resolve_workload(s.workload))
    inv, st = _het_state(s)
    sk = normalize_sync_k(s.sync_k)
    costs = costs0 if inv is None else _scale_compute(
        costs0, float(_kth_tmul(inv[None, :], sk)[0]))
    t_iter = float(analytical.closed_form(costs, policy))
    t1 = float(analytical.closed_form(
        costs.with_comm(np.zeros_like(costs.t_f)), policy))
    tails = None
    st_live = st is not None and not st.is_deterministic
    ft, cm = _fault_state(s, seed,
                          st.draws if st_live else None)
    if st_live or cm is not None:
        D = st.draws if st_live else ft.draws
        J = st.draw_matrix(s.n_workers, seed) if st_live \
            else np.ones((D, s.n_workers))
        tmuls = _kth_tmul(J if inv is None else J * inv, sk)
        pens = np.zeros(D) if cm is None else ft.restart * cm.sum(axis=1)
        tails = _ref_tails([
            float(analytical.closed_form(
                replace(_scale_compute(costs0, m), t_u=costs0.t_u + p),
                policy))
            for m, p in zip(tmuls, pens)])
    return _row(s, batch, t_iter, t1, float(np.sum(costs.t_c)),
                float(np.sum(costs.t_f) + np.sum(costs.t_b)), "analytical",
                tails=tails)


def _sim_eval(s: Scenario, warm_iterations: int = 6, seed: int = 0) -> dict:
    """Event-driven fallback: build the Fig.-1 DAG and list-schedule.

    This is the per-worker oracle for the heterogeneity engine: the
    per-worker rate vector goes to the DAG builder *unreduced*
    (``worker_scale``), so agreement with the batched path validates
    the slowest-worker theorem rather than assuming it.  Stochastic
    stragglers re-simulate per draw with ``jitter * inv_speed``.  The
    failure model goes to the builder equally unreduced: ``sync_k``
    gates the DAG's aggregation edges on the K fastest workers, and
    each draw's crashed-worker set becomes serialized checkpoint
    restores — agreement with the batched closed form validates the
    K-th-order-statistic reduction and the additive restore chain."""
    tab = resolve_workload(s.workload)
    costs, cluster, policy, batch = _scenario_costs(s, tab)
    inv, st = _het_state(s)
    sk = normalize_sync_k(s.sync_k)
    comm_scale = comm_scale_fn(cluster, s.n_workers, s.collective) \
        if policy.bucket_bytes else None
    t_iter = simulate_steady(costs, s.n_workers, policy,
                             n_iterations=warm_iterations,
                             comm_scale=comm_scale,
                             worker_scale=inv,
                             sync_k=sk or None)
    # weak-scaling baseline: same pipeline, one worker, no comm — with
    # the same bottleneck compute rate, matching the batched speedup
    base_policy = replace(policy, bucket_bytes=None, priority_comm=False)
    c1 = costs.with_comm([0.0] * costs.num_layers)
    if inv is not None:
        c1 = _scale_compute(c1, float(_kth_tmul(inv[None, :], sk)[0]))
    t1 = analytical.closed_form(c1, base_policy)
    if t1 is None:                                    # pragma: no cover
        t1 = simulate_steady(c1, 1, base_policy, n_iterations=warm_iterations)
    tails = None
    st_live = st is not None and not st.is_deterministic
    ft, cm = _fault_state(s, seed, st.draws if st_live else None)
    if st_live or cm is not None:
        D = st.draws if st_live else ft.draws
        J = st.draw_matrix(s.n_workers, seed) if st_live \
            else np.ones((D, s.n_workers))
        mul = J if inv is None else J * inv
        crash_sets = [()] * D if cm is None else \
            [tuple(np.nonzero(c)[0].tolist()) for c in cm]
        tails = _ref_tails([
            simulate_steady(costs, s.n_workers, policy,
                            n_iterations=warm_iterations,
                            comm_scale=comm_scale,
                            worker_scale=m,
                            sync_k=sk or None,
                            crashed=crashed,
                            restart_s=0.0 if ft is None else ft.restart)
            for m, crashed in zip(mul, crash_sets)])
    return _row(s, batch, t_iter, t1, float(np.sum(costs.t_c)),
                float(np.sum(costs.t_f) + np.sum(costs.t_b)), "simulated",
                tails=tails)


def _row(s: Scenario, batch: int, t_iter: float, t1: float, t_comm: float,
         t_comp: float, method: str,
         tails: tuple[float, float, float] | None = None) -> dict:
    t_mean, t_p95, t_p99 = tails if tails is not None \
        else (t_iter, t_iter, t_iter)
    return {
        "workload": s.workload,
        "cluster": s.cluster,
        "n_workers": s.n_workers,
        "policy": s.policy,
        "collective": s.collective,
        "interconnect": normalize_interconnect(s.interconnect),
        "het": het_mod.normalize_het(s.het),
        "straggler": het_mod.normalize_straggler(s.straggler),
        "sync_k": normalize_sync_k(s.sync_k),
        "faults": het_mod.normalize_fault(s.faults),
        "batch_per_gpu": batch,
        "iteration_time_s": t_iter,
        "samples_per_sec": s.n_workers * batch / t_iter if t_iter else 0.0,
        "speedup": s.n_workers * t1 / t_iter if t_iter else float(s.n_workers),
        "t_comm_s": t_comm,
        "t_comp_s": t_comp,
        "t_mean_s": t_mean,
        "t_p95_s": t_p95,
        "t_p99_s": t_p99,
        "method": method,
    }


@dataclass
class SweepResult:
    """Tidy results table, stored **columnar**: ``columns`` maps each
    :data:`COLUMNS` key to one ``(n,)`` NumPy array.  :attr:`rows` is the
    lazy per-row view.  ``n_analytical`` counts closed-form rows,
    ``n_timeline`` bucket-timeline rows and ``n_simulated`` event-driven
    simulator rows; ``backend`` records which engine produced the rows."""

    columns: dict[str, np.ndarray]
    elapsed_s: float
    n_analytical: int
    n_simulated: int
    n_timeline: int = 0
    backend: str = "torch"
    _rows: list | None = field(default=None, repr=False, compare=False)

    @property
    def rows(self) -> list[dict]:
        """Per-row dict view of :attr:`columns` (cached)."""
        if self._rows is None:
            self._rows = rows_from_table(self.columns)
        return self._rows

    def __len__(self) -> int:
        return table_len(self.columns)

    @property
    def scenarios_per_sec(self) -> float:
        return len(self) / self.elapsed_s if self.elapsed_s else 0.0

    def _col(self, column: str) -> np.ndarray:
        try:
            return self.columns[column]
        except KeyError:
            raise KeyError(
                f"unknown column {column!r}; one of "
                f"{', '.join(COLUMNS)}") from None

    def sorted_by(self, column: str, reverse: bool = True) -> list[dict]:
        """Rows ordered by ``column`` — a stable argsort (ties keep grid
        order, as ``sorted(rows, ...)`` would)."""
        col = self._col(column)
        if reverse:
            n = len(col)
            idx = (n - 1 - np.argsort(col[::-1], kind="stable"))[::-1]
        else:
            idx = np.argsort(col, kind="stable")
        return rows_from_table(self.columns, idx)

    def filter(self, **eq) -> list[dict]:
        """Rows matching all ``column=value`` pairs; ``interconnect``,
        ``het``, ``straggler``, ``faults`` and ``sync_k`` accept ``None``
        for their "default" / "none" / full-sync spellings."""
        if "interconnect" in eq:
            eq["interconnect"] = normalize_interconnect(eq["interconnect"])
        if "het" in eq:
            eq["het"] = het_mod.normalize_het(eq["het"])
        if "straggler" in eq:
            eq["straggler"] = het_mod.normalize_straggler(eq["straggler"])
        if "faults" in eq:
            eq["faults"] = het_mod.normalize_fault(eq["faults"])
        if "sync_k" in eq:
            eq["sync_k"] = normalize_sync_k(eq["sync_k"])
        mask = np.ones(len(self), dtype=bool)
        for k, v in eq.items():
            mask &= self._col(k) == v
        return rows_from_table(self.columns, np.nonzero(mask)[0])

    def to_csv(self, path) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(COLUMNS)
            w.writerows(zip(*(self.columns[k].tolist() for k in COLUMNS)))

    def meta(self) -> dict:
        """Sweep metadata in :data:`RESULT_META_KEYS` order."""
        return {
            "n_scenarios": len(self),
            "elapsed_s": self.elapsed_s,
            "scenarios_per_sec": self.scenarios_per_sec,
            "n_analytical": self.n_analytical,
            "n_timeline": self.n_timeline,
            "n_simulated": self.n_simulated,
            "backend": self.backend,
        }

    def to_json(self, path=None, indent: int | None = 2) -> str:
        """The full result as a JSON document (and optionally write it to
        ``path``): sweep metadata plus the tidy rows."""
        doc = {"columns": list(COLUMNS), **self.meta(), "rows": self.rows}
        text = json.dumps(doc, indent=indent)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def to_dataframe(self):
        """Results as a pandas DataFrame, built column-wise from the arrays.
        pandas is optional and imported here only; the card's machine has
        none, so this raises ``ImportError`` there."""
        import pandas as pd

        return pd.DataFrame({k: self.columns[k] for k in COLUMNS},
                            columns=list(COLUMNS))

    def format_table(self, rows: Sequence[dict] | None = None,
                     limit: int | None = None) -> str:
        """The reference's printed table (:meth:`repro.core.sweep.SweepResult.format_table`)."""
        if rows is None:
            n = len(self) if limit is None else min(limit, len(self))
            rows = rows_from_table(self.columns, np.arange(n))
        else:
            rows = list(rows)
            if limit is not None:
                rows = rows[:limit]
        with_het = any(r["het"] != "none" or r["straggler"] != "none"
                       for r in rows)
        with_fail = any(r["sync_k"] != 0 or r["faults"] != "none"
                        for r in rows)
        header = (f"{'workload':22s} {'cluster':16s} {'wk':>3s} "
                  f"{'policy':13s} {'coll':12s} {'interconn':12s} "
                  f"{'iter_ms':>9s} {'samp/s':>10s} {'speedup':>7s} {'m':>2s}")
        if with_het:
            header += (f" {'het':18s} {'straggler':18s} "
                       f"{'p99_ms':>9s}")
        if with_fail:
            header += f" {'k':>3s} {'faults':26s}"
        lines = [header, "-" * len(header)]
        for r in rows:
            line = (
                f"{r['workload']:22s} {r['cluster']:16s} "
                f"{r['n_workers']:3d} {r['policy']:13s} "
                f"{r['collective']:12s} {r['interconnect']:12s} "
                f"{r['iteration_time_s'] * 1e3:9.2f} "
                f"{r['samples_per_sec']:10.0f} {r['speedup']:7.2f} "
                f"{r['method'][:1]:>2s}")
            if with_het:
                line += (f" {r['het'][:18]:18s} {r['straggler'][:18]:18s} "
                         f"{r['t_p99_s'] * 1e3:9.2f}")
            if with_fail:
                line += f" {r['sync_k']:3d} {r['faults'][:26]:26s}"
            lines.append(line)
        return "\n".join(lines)


#: Scenarios evaluated per batched kernel call — bounds transient
#: ``(S, L)`` matrix memory on huge (frontier-sized) grids without
#: measurably hurting throughput.
DEFAULT_CHUNK = 8192

#: Evaluation backends :func:`sweep` / :func:`iter_rows` / :func:`stream`
#: accept: the batched kernel on the card (the default) and the port's
#: copy of the NumPy engine, with its simulator and reference paths.
BACKENDS = ("torch", "numpy")

#: Metadata keys every result surface shares — the
#: :meth:`SweepResult.to_json` document minus ``columns``/``rows``,
#: the :func:`stream` JSON trailer and return value, and the sweep
#: service's per-query trailer (:mod:`repro_torch.core.service`).
RESULT_META_KEYS = ("n_scenarios", "elapsed_s", "scenarios_per_sec",
                    "n_analytical", "n_timeline", "n_simulated", "backend")


def _check_backend(backend: str, device, *, batched: bool,
                   force_simulator: bool) -> None:
    """Reject invalid ``backend`` combinations loudly — the torch backend
    has no per-scenario reference path and no event-driven fallback, and
    silently falling back to NumPy would defeat the point of selecting
    it; the NumPy backend runs on the host and takes no device."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "numpy" and device is not None:
        raise ValueError(f"backend='numpy' runs on the host; device={device!r} "
                         f"applies to backend='torch' only")
    if backend == "torch" and not batched:
        raise ValueError(
            "backend='torch' IS the batched kernel; batched=False pins the "
            "per-scenario NumPy reference paths, which have no torch "
            "counterpart. Drop batched=False or use backend='numpy'.")
    if backend == "torch" and force_simulator:
        raise ValueError(
            "force_simulator=True routes every scenario through the "
            "event-driven NumPy simulator — there is no torch simulator to "
            "force. Drop force_simulator or use backend='numpy'.")


def _fill_simulated(table: dict, batched_mask: np.ndarray, ev, lo: int,
                    warm_iterations: int, seed: int = 0) -> None:
    """Overwrite the tier-2 placeholder rows of a chunk table with
    event-driven simulator results, in place."""
    idx = np.nonzero(~batched_mask)[0]
    if len(idx):
        fill_rows(table, idx,
                  [_sim_eval(ev.scenario_at(lo + int(i)), warm_iterations,
                             seed=seed)
                   for i in idx])


def _reference_rows(scenarios: Sequence[Scenario], *,
                    force_simulator: bool, warm_iterations: int,
                    batched: bool, chunk: int,
                    seed: int = 0) -> Iterator[list[dict]]:
    """The per-scenario reference paths, chunk by chunk:
    :func:`_fast_eval` for closed forms (or the batched list kernel
    when ``batched``), the event-driven simulator for the rest — the
    agreement oracles and the slow side of the throughput benchmark."""
    # per-policy evaluation tier: 2 = closed form, 1 = bucket-timeline
    # form (batched kernel only), 0 = simulator-only
    tier_of: dict[str, int] = {}
    for lo in range(0, len(scenarios), chunk):
        part = scenarios[lo:lo + chunk]
        fast: list[int] = []
        for i, s in enumerate(part):
            tier = tier_of.get(s.policy)
            if tier is None:
                pol = resolve_policy(s)
                tier = tier_of[s.policy] = 2 if has_fast_path(pol) \
                    else (1 if has_batched_path(pol) else 0)
            if force_simulator:
                continue
            # batched=False pins the per-scenario reference paths:
            # _fast_eval for closed forms, the simulator for the rest
            if tier >= (1 if batched else 2):
                fast.append(i)
        if batched and fast:
            fast_rows = iter(eval_scenarios([part[i] for i in fast],
                                            seed=seed))
        else:
            fast_rows = iter([_fast_eval(part[i], seed=seed) for i in fast])
        fast_set = set(fast)
        yield [next(fast_rows) if i in fast_set
               else _sim_eval(s, warm_iterations, seed=seed)
               for i, s in enumerate(part)]


def iter_tables(grid: ScenarioGrid | Iterable[Scenario], *,
                force_simulator: bool = False,
                warm_iterations: int = 6,
                batched: bool = True,
                backend: str = "torch",
                chunk: int = DEFAULT_CHUNK,
                jobs: int | None = None,
                pool: str = "process",
                seed: int = 0,
                device=None) -> Iterator[dict]:
    """Yield columnar result tables in scenario order, lazily — the
    single evaluation core behind :func:`sweep`, :func:`iter_rows` and
    :func:`stream`.  Each yielded table maps every :data:`COLUMNS` key
    to one NumPy array of ``<= chunk`` rows (exactly ``chunk`` except
    the last), so no more than one chunk is ever buffered.

    Routing: ``backend="torch"`` evaluates a :class:`ScenarioGrid` through
    the memoized grid evaluator on ``device``
    (:meth:`repro_torch.core.batched_torch.TorchGridRun.table_slice`) and a
    scenario list chunk by chunk through
    :func:`repro_torch.core.batched_torch.eval_scenarios_table_torch`;
    ``jobs`` does nothing there.  On ``backend="numpy"`` a grid on the
    default arguments goes straight through the batched grid kernel
    (:meth:`repro_torch.core.batched.GridRun.table_slice`), with
    simulator-fallback rows overwritten in place; ``jobs > 1`` shards the
    grid's chunks across a worker pool
    (:func:`repro_torch.core.parallel.parallel_tables` — order-preserving,
    bit-identical to serial).  Scenario lists and the reference paths
    (``batched=False`` / ``force_simulator=True``) produce per-row dicts and
    are wrapped into tables chunk by chunk.

    ``seed`` keys the straggler and fault Monte Carlo draws (no effect on
    deterministic scenarios); every route threads it to the same keyed
    generator, so results are independent of backend, sharding and
    chunking.
    """
    _check_backend(backend, device, batched=batched,
                   force_simulator=force_simulator)
    if backend == "torch":
        from repro_torch.core.batched_torch import (eval_scenarios_table_torch,
                                                    torch_grid_evaluator)

        if isinstance(grid, ScenarioGrid):
            run = torch_grid_evaluator(grid, device=device).run(seed=seed)
            for lo in range(0, len(run), chunk):
                yield run.table_slice(lo, min(lo + chunk, len(run)))[0]
        else:
            scenarios = list(grid)
            for s in scenarios:
                s.validate()
            for lo in range(0, len(scenarios), chunk):
                yield eval_scenarios_table_torch(scenarios[lo:lo + chunk],
                                                 seed=seed, device=device)
        return
    if isinstance(grid, ScenarioGrid) and batched and not force_simulator:
        if jobs is not None and jobs > 1:
            from repro_torch.core.parallel import parallel_tables

            yield from parallel_tables(grid, jobs=jobs, chunk=chunk,
                                       warm_iterations=warm_iterations,
                                       pool=pool, seed=seed)
            return
        ev = grid_evaluator(grid)
        run = ev.run(seed=seed)
        for lo in range(0, len(run), chunk):
            table, mask = run.table_slice(lo, min(lo + chunk, len(run)))
            if not ev.all_batched:
                _fill_simulated(table, mask, ev, lo, warm_iterations,
                                seed=seed)
            yield table
        return
    if isinstance(grid, ScenarioGrid):
        scenarios = grid.expand()          # validates the axes
    else:
        scenarios = list(grid)
        for s in scenarios:
            s.validate()
    for part in _reference_rows(scenarios, force_simulator=force_simulator,
                                warm_iterations=warm_iterations,
                                batched=batched, chunk=chunk, seed=seed):
        yield table_from_rows(part)


def iter_rows(grid: ScenarioGrid | Iterable[Scenario], *,
              force_simulator: bool = False,
              warm_iterations: int = 6,
              batched: bool = True,
              backend: str = "torch",
              chunk: int = DEFAULT_CHUNK,
              jobs: int | None = None,
              seed: int = 0,
              device=None) -> Iterator[dict]:
    """Yield tidy result rows in scenario order, lazily — the per-row
    view of :func:`iter_tables` (one chunk of rows is materialized at
    a time; for columnar access use :func:`iter_tables` directly)."""
    for table in iter_tables(grid, force_simulator=force_simulator,
                             warm_iterations=warm_iterations,
                             batched=batched, backend=backend,
                             chunk=chunk, jobs=jobs, seed=seed,
                             device=device):
        yield from rows_from_table(table)


def sweep(grid: ScenarioGrid | Iterable[Scenario], *,
          force_simulator: bool = False,
          warm_iterations: int = 6,
          batched: bool = True,
          backend: str = "torch",
          jobs: int | None = None,
          chunk: int | None = None,
          seed: int = 0,
          device=None) -> SweepResult:
    """Evaluate every scenario of ``grid`` and return the tidy table.

    ``backend="torch"`` (the default) evaluates on ``device`` (CUDA unless
    ``"cpu"``) through the batched kernel's two tiers
    (:mod:`repro_torch.core.batched_torch`); rows agree with the NumPy
    engine to <= 1e-6 relative.  It has no reference or simulator path, so
    ``batched=False`` / ``force_simulator=True`` / grids with
    simulator-only policies raise ``ValueError`` rather than silently
    falling back, and ``jobs`` is a no-op on it.

    ``backend="numpy"``: closed-form and bucket-timeline scenarios go
    through the scenario-axis batched kernel
    (:mod:`repro_torch.core.batched`), the rest through the event-driven
    simulator.  ``batched=False`` pins every scenario to its per-scenario
    reference path instead — ``_fast_eval`` for closed forms (same rows to
    <= 1e-9 relative), the simulator for bucketed/priority policies
    (<= 1e-6).  ``force_simulator=True`` routes *all* scenarios through the
    event-driven simulator — the agreement oracle.  ``jobs=N`` (grid
    sweeps) shards chunks across ``N`` worker processes
    (:mod:`repro_torch.core.parallel`) — output is bit-identical to serial,
    in the same order.

    ``seed`` keys the straggler Monte Carlo draws; same grid + same
    seed reproduces the tail columns exactly on every backend.
    """
    _check_backend(backend, device, batched=batched,
                   force_simulator=force_simulator)
    t0 = time.perf_counter()
    grid_batched = isinstance(grid, ScenarioGrid) and batched \
        and not force_simulator
    if chunk is None:
        if grid_batched and (jobs is None or jobs <= 1):
            # one whole-grid chunk: a single table, no concat
            chunk = max(len(grid), 1)
        else:
            chunk = DEFAULT_CHUNK
    columns = concat_tables(list(iter_tables(
        grid, force_simulator=force_simulator,
        warm_iterations=warm_iterations, batched=batched,
        backend=backend, chunk=chunk, jobs=jobs, seed=seed,
        device=device)))
    elapsed = time.perf_counter() - t0
    if grid_batched:
        # static counts from the grid structure — no label scan
        ev = grid_evaluator(grid)
        n_fast, n_tl = ev.n_fast, ev.n_timeline
        n_slow = 0 if backend == "torch" else len(ev) - n_fast - n_tl
    else:
        n_fast, n_tl, n_slow = method_counts(columns)
    return SweepResult(columns=columns, elapsed_s=elapsed,
                       n_analytical=n_fast, n_timeline=n_tl,
                       n_simulated=n_slow, backend=backend)


def stream(grid: ScenarioGrid | Iterable[Scenario], *,
           csv_path=None, json_path=None,
           force_simulator: bool = False, warm_iterations: int = 6,
           batched: bool = True, backend: str = "torch",
           chunk: int = DEFAULT_CHUNK, jobs: int | None = None,
           seed: int = 0, device=None) -> dict:
    """Evaluate ``grid`` **once** and write the tidy table to
    ``csv_path`` and/or ``json_path`` incrementally — one chunk of
    rows in memory at a time, both formats fed from the same pass.
    Returns summary metadata (``n_scenarios`` / ``elapsed_s`` /
    ``scenarios_per_sec`` / ``n_analytical`` / ``n_simulated``).

    The JSON document has the :meth:`SweepResult.to_json` shape (same
    keys; ``rows`` first so the array can stream, counts and timing in
    the trailer).

    Writes are **atomic**: each output streams to ``<path>.tmp`` and is
    renamed over ``path`` only after the whole pass succeeds, so an
    exception mid-sweep (a bad scenario in a late chunk, a killed
    worker) can never leave a truncated CSV or an unterminated JSON
    document behind — the temp file is removed and any pre-existing
    ``path`` is untouched.
    """
    if csv_path is None and json_path is None:
        raise ValueError("stream() needs csv_path and/or json_path")
    _check_backend(backend, device, batched=batched,
                   force_simulator=force_simulator)
    t0 = time.perf_counter()
    n_fast = n_tl = n_slow = 0
    csv_tmp = None if csv_path is None else str(csv_path) + ".tmp"
    json_tmp = None if json_path is None else str(json_path) + ".tmp"
    csv_file = json_file = None
    ok = False
    try:
        if csv_tmp is not None:
            csv_file = open(csv_tmp, "w", newline="")
            writer = csv.writer(csv_file)
            writer.writerow(COLUMNS)
        if json_tmp is not None:
            json_file = open(json_tmp, "w")
            json_file.write('{\n  "columns": %s,\n  "rows": ['
                            % json.dumps(list(COLUMNS)))
        first = True
        for table in iter_tables(grid, force_simulator=force_simulator,
                                 warm_iterations=warm_iterations,
                                 batched=batched, backend=backend,
                                 chunk=chunk, jobs=jobs, seed=seed,
                                 device=device):
            if csv_file is not None:
                writer.writerows(
                    zip(*(table[k].tolist() for k in COLUMNS)))
            if json_file is not None:
                for r in rows_from_table(table):
                    json_file.write(("\n    " if first else ",\n    ")
                                    + json.dumps(r))
                    first = False
            f, tl, _ = method_counts(table)
            n_fast += f
            n_tl += tl
            n_slow += table_len(table) - f - tl
        elapsed = time.perf_counter() - t0
        n = n_fast + n_tl + n_slow
        rate = n / elapsed if elapsed else 0.0
        meta = {"n_scenarios": n, "elapsed_s": elapsed,
                "scenarios_per_sec": rate, "n_analytical": n_fast,
                "n_timeline": n_tl, "n_simulated": n_slow,
                "backend": backend}
        if json_file is not None:
            # trailer keys == RESULT_META_KEYS == the to_json key set
            # minus columns/rows (parity pinned by the tests)
            json_file.write(
                "\n  ]," + ",".join(f'\n  "{k}": {json.dumps(meta[k])}'
                                    for k in RESULT_META_KEYS) + "\n}\n")
        ok = True
    finally:
        for f in (csv_file, json_file):
            if f is not None:
                f.close()
        if ok:
            if csv_tmp is not None:
                os.replace(csv_tmp, csv_path)
            if json_tmp is not None:
                os.replace(json_tmp, json_path)
        else:
            for tmp in (csv_tmp, json_tmp):
                if tmp is not None and os.path.exists(tmp):
                    os.unlink(tmp)
    return meta


def stream_csv(grid: ScenarioGrid | Iterable[Scenario], path,
               **kw) -> dict:
    """:func:`stream` to a single CSV file."""
    return stream(grid, csv_path=path, **kw)


def stream_json(grid: ScenarioGrid | Iterable[Scenario], path,
                **kw) -> dict:
    """:func:`stream` to a single JSON document."""
    return stream(grid, json_path=path, **kw)


def evaluate_scenario(s: Scenario, method: str = "auto",
                      warm_iterations: int = 6, seed: int = 0) -> dict:
    """Evaluate one scenario; ``method`` is ``auto`` (closed form when
    exact, else the batched bucket-timeline kernel, else the
    simulator), ``analytical`` (raise unless the per-layer closed form
    applies) or ``simulator``.  ``seed`` keys the straggler draws."""
    s.validate()
    policy = resolve_policy(s)
    if method == "simulator":
        return _sim_eval(s, warm_iterations, seed=seed)
    if method == "analytical":
        if not has_fast_path(policy):
            raise ValueError(f"policy {s.policy!r} has no exact closed form")
        return _fast_eval(s, seed=seed)
    if method != "auto":
        raise ValueError(f"unknown method {method!r}")
    if has_fast_path(policy):
        return _fast_eval(s, seed=seed)
    if has_batched_path(policy):
        return eval_scenarios([s], seed=seed)[0]
    return _sim_eval(s, warm_iterations, seed=seed)
