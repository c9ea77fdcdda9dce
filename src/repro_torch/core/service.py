"""Persistent sweep service: hot caches, query micro-batching, QoS.

A copy of :mod:`repro.core.service`, with the port's two backends: the
engine behind the what-if server (:mod:`repro_torch.launch.serve_sweep`).
A one-shot CLI sweep pays full preparation on every invocation —
workload-table resolution, grid-structure memos, tables copied to the
card — before the kernel's throughput shows up.  :class:`SweepService`
amortizes all of it across a process lifetime:

* **Request queue → micro-batching coalescer.**  Queries land on a
  queue; a dispatcher thread collects everything that arrives within a
  short batch window (``window_s``) and groups it by **kernel
  signature** ``(backend, seed, padded layer depth)`` — see
  :attr:`Query.signature` for why the padding depth is part of the
  key.  Heterogeneous queries — different grids,
  het/straggler/sync-k/fault axes — share a signature as long as
  their policies are batched-eligible, because the scenario-list
  kernels are row-wise over ``(S, L)`` matrices.
* **One fused kernel call per group.**  A group's queries have their
  scenario lists concatenated and evaluated by **one**
  :func:`repro_torch.core.batched_torch.eval_scenarios_table_torch` call
  on the service's device (``backend="torch"``, the default) or one
  :func:`repro_torch.core.batched.eval_scenarios_table` call
  (``backend="numpy"``); the resulting columnar table is de-multiplexed
  back per query by offset (:func:`repro_torch.core.resulttable.slice_table`
  — views, not copies).  On NumPy a coalesced query's columns are
  **bit-identical** to a direct :func:`sweep` of its grid, as in the
  reference.  On the torch backend the grid and list front ends reduce
  over the layer axis in tensors of different row counts, so the tests
  pin whether the two agree bit for bit on the device at hand, and hold
  them to 1e-12 relative otherwise.  A group of one routes through the
  memoized grid front end instead, and the structure memos
  (:func:`repro_torch.core.batched.grid_evaluator` /
  :func:`repro_torch.core.batched_torch.torch_grid_evaluator`) stay hot
  for repeated queries.
* **Process-lifetime caches.**  Workload tables
  (``repro_torch.core.workloads._TABLES``) and grid-structure memos (with
  their tables on the device) live as long as the service; the service
  additionally memoizes grid expansions (the coalescer's Python-side
  cost).  Cache hit/miss rates are *probed* per query
  (:func:`repro_torch.core.batched.evaluator_cached`,
  :func:`repro_torch.core.batched_torch.torch_evaluator_cached`,
  :func:`repro_torch.core.workloads.workload_cached`) without perturbing
  the caches being measured.
* **QoS telemetry** (:class:`ServiceStats`): per-query latency and
  queue-wait percentiles, queue depth, coalesce factor (queries per
  kernel call), cache hit rates, sustained scenarios/s over kernel-busy
  time, error counts — served by the launcher's ``/stats`` endpoint
  and echoed per query in the streamed trailer's ``qos`` entry.

Degenerate queries never take the service down and never divide by
zero: :func:`parse_query` rejects malformed specs, unknown axis values
and backends (``"jax"`` included), and zero-scenario grids with a
structured :class:`QueryError` (a stable ``code`` plus the same
human-readable message the CLI prints before exiting 2), and evaluation
failures resolve only the tickets of the failing group: nothing falls
back to the CPU or to NumPy.

The trailer of every query carries the
:data:`repro_torch.core.sweep.RESULT_META_KEYS` metadata —
``scenarios_per_sec`` guarded against zero elapsed — plus the ``qos``
dict, mirroring :meth:`repro_torch.core.sweep.SweepResult.to_json` key for
key.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from queue import Empty, Queue

import numpy as np

from repro_torch.core import analytical
from repro_torch.core.batched import eval_scenarios_table, evaluator_cached
from repro_torch.core.batched_torch import (eval_scenarios_table_torch,
                                            torch_evaluator_cached)
from repro_torch.core.policies import get_policy
from repro_torch.core.resulttable import method_counts, slice_table, table_len
from repro_torch.core.scenarios import (BASE_GRIDS, GRID_SPEC_KEYS, Scenario,
                                        ScenarioGrid, grid_from_spec)
from repro_torch.core.sweep import BACKENDS, RESULT_META_KEYS, sweep
from repro_torch.core.workloads import resolve_workload, workload_cached
from repro_torch.device import resolve_device


class QueryError(ValueError):
    """Structured rejection of a query — the server-side counterpart
    of the CLI's exit-2 path.  ``code`` is a stable machine-readable
    slug (``bad-query`` / ``empty-grid`` / ``evaluation-failed``);
    ``str(exc)`` the human-readable message."""

    def __init__(self, message: str, code: str = "bad-query"):
        super().__init__(message)
        self.code = code


#: Keys a query document may carry: the grid-spec vocabulary plus the
#: evaluation knobs.
QUERY_KEYS = ("grid",) + GRID_SPEC_KEYS + ("backend", "seed")


@dataclass(frozen=True)
class Query:
    """One parsed, validated what-if query: a grid plus the kernel
    signature ``(backend, seed)`` it must be evaluated under.
    ``coalescable`` is False only when the grid contains a policy with
    neither batched form (such queries are served solo through the
    NumPy simulator fallback, never fused with others)."""

    grid: ScenarioGrid
    backend: str = "torch"
    seed: int = 0
    coalescable: bool = True

    @property
    def signature(self) -> tuple:
        """The kernel-compatibility key.  Besides backend and seed it
        carries the grid's **padded layer depth**: the kernels zero-pad
        every workload's layer tables to the batch's deepest workload
        and reduce with ``.sum(axis=1)``, whose pairwise-summation tree
        depends on the padded length — so bit-identity with a direct
        per-grid sweep requires that coalescing never change a query's
        padding.  Grouping by equal depth guarantees the union's
        ``L_max`` equals each member's own."""
        lmax = max(resolve_workload(w).num_layers
                   for w in self.grid.workloads)
        return (self.backend, self.seed, lmax)


def parse_query(doc: dict) -> Query:
    """A :class:`Query` from a wire document, or :class:`QueryError`.

    The document is the :func:`repro_torch.core.scenarios.grid_from_spec`
    vocabulary (``grid`` / axis keys) plus ``backend`` and ``seed`` —
    every grid the sweep CLI accepts is expressible, and every spec the
    CLI exits 2 on is rejected here with the same message."""
    if not isinstance(doc, dict):
        raise QueryError(f"query must be a JSON object, "
                         f"got {type(doc).__name__}")
    unknown = set(doc) - set(QUERY_KEYS)
    if unknown:
        raise QueryError(f"unknown query keys {sorted(unknown)}; "
                         f"known keys: {', '.join(QUERY_KEYS)}")
    backend = doc.get("backend", "torch")
    if backend not in BACKENDS:
        raise QueryError(f"unknown backend {backend!r}; "
                         f"one of {BACKENDS}")
    seed = doc.get("seed", 0)
    if isinstance(seed, bool) or not isinstance(seed, int):
        raise QueryError(f"seed must be an integer, got {seed!r}")
    try:
        grid = grid_from_spec({k: v for k, v in doc.items()
                               if k not in ("backend", "seed")})
    except (ValueError, KeyError) as e:
        raise QueryError(str(e)) from None
    if len(grid) == 0:
        raise QueryError("zero-scenario grid: every axis needs at least "
                         "one value", code="empty-grid")
    coalescable = True
    for name in grid.policies:
        pol = get_policy(name)       # validated by grid_from_spec
        if not (analytical.has_closed_form(pol)
                or analytical.has_timeline_form(pol)):
            if backend == "torch":
                raise QueryError(
                    f"backend='torch' cannot evaluate simulator-only "
                    f"policy {name!r}; use backend='numpy'")
            coalescable = False
    return Query(grid=grid, backend=backend, seed=seed,
                 coalescable=coalescable)


@dataclass
class QueryResult:
    """One finished query: the columnar result table (the same column
    arrays a direct :func:`repro_torch.core.sweep.sweep` would produce) and
    the trailer metadata (:data:`RESULT_META_KEYS` plus ``qos``)."""

    table: dict
    meta: dict


class QueryTicket:
    """A submitted query's handle: :meth:`wait` blocks until the
    dispatcher resolves it with a result or an error."""

    def __init__(self, query: Query):
        self.query = query
        self.t_submit = time.perf_counter()
        self.t_dispatch = self.t_submit
        self.cache_probe: dict = {}
        self._done = threading.Event()
        self._result: QueryResult | None = None
        self._error: Exception | None = None

    def _resolve(self, result: QueryResult | None = None,
                 error: Exception | None = None) -> None:
        self._result = result
        self._error = error
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> QueryResult:
        if not self._done.wait(timeout):
            raise TimeoutError(f"query not served within {timeout}s")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result


class ServiceStats:
    """Thread-safe QoS counters; :meth:`snapshot` returns a JSON-ready
    dict (the ``/stats`` document).  Latency/queue-wait percentiles
    are over a sliding window of the most recent queries."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.n_queries = 0
        self.n_errors = 0
        self.n_scenarios = 0
        self.kernel_calls = 0
        self.kernel_queries = 0
        self.kernel_busy_s = 0.0
        self._latencies: deque = deque(maxlen=window)
        self._queue_waits: deque = deque(maxlen=window)
        self.cache = {name: {"hits": 0, "misses": 0}
                      for name in ("grid_structure", "workload_tables")}

    def record_cache(self, name: str, hit: bool) -> None:
        with self._lock:
            self.cache[name]["hits" if hit else "misses"] += 1

    def record_kernel(self, n_queries: int, n_scenarios: int,
                      busy_s: float) -> None:
        with self._lock:
            self.kernel_calls += 1
            self.kernel_queries += n_queries
            self.kernel_busy_s += busy_s
            self.n_scenarios += n_scenarios

    def record_query(self, latency_s: float, queue_wait_s: float) -> None:
        with self._lock:
            self.n_queries += 1
            self._latencies.append(latency_s)
            self._queue_waits.append(queue_wait_s)

    def record_error(self) -> None:
        with self._lock:
            self.n_errors += 1

    @staticmethod
    def _pcts_ms(values) -> dict:
        if not values:
            return {"count": 0, "p50_ms": 0.0, "p95_ms": 0.0,
                    "p99_ms": 0.0, "max_ms": 0.0}
        a = np.sort(np.asarray(values, dtype=np.float64)) * 1e3
        return {"count": int(len(a)),
                "p50_ms": float(np.quantile(a, 0.50)),
                "p95_ms": float(np.quantile(a, 0.95)),
                "p99_ms": float(np.quantile(a, 0.99)),
                "max_ms": float(a[-1])}

    def snapshot(self, queue_depth: int = 0) -> dict:
        with self._lock:
            lat = list(self._latencies)
            waits = list(self._queue_waits)
            cache = {
                name: {**c, "hit_rate": (c["hits"] / total
                                         if (total := c["hits"]
                                             + c["misses"]) else 0.0)}
                for name, c in self.cache.items()}
            return {
                "uptime_s": time.perf_counter() - self._t0,
                "n_queries": self.n_queries,
                "n_errors": self.n_errors,
                "n_scenarios_served": self.n_scenarios,
                "kernel_calls": self.kernel_calls,
                "coalesce_factor": (self.kernel_queries / self.kernel_calls
                                    if self.kernel_calls else 0.0),
                "sustained_scenarios_per_sec": (
                    self.n_scenarios / self.kernel_busy_s
                    if self.kernel_busy_s else 0.0),
                "queue_depth": queue_depth,
                "latency": self._pcts_ms(lat),
                "queue_wait": self._pcts_ms(waits),
                "cache": cache,
            }


class _Close:
    """Queue sentinel that wakes the dispatcher for shutdown."""


class SweepService:
    """The persistent what-if engine: submit queries from any thread,
    get :func:`sweep`'s columnar results back, with concurrent
    same-signature queries fused into shared kernel calls.  ``device`` is
    where ``backend="torch"`` queries run: CUDA unless ``"cpu"`` is asked
    for (:func:`repro_torch.device.resolve_device`; no GPU is an error
    here, not a fallback).

    ``window_s`` is the micro-batch window: after the first query of a
    batch arrives, the dispatcher keeps collecting for up to
    ``window_s`` seconds (or ``max_coalesce`` queries) before
    evaluating — the classic throughput/latency dial.  ``window_s=0``
    disables coalescing except for queries already waiting in the
    queue.

    Use as a context manager, or call :meth:`close` — in-flight
    queries are served, queued-but-unserved ones resolve with a
    ``service closed`` error.
    """

    def __init__(self, *, window_s: float = 0.005, max_coalesce: int = 32,
                 stats_window: int = 2048, device=None):
        self.device = resolve_device(device)
        self.window_s = float(window_s)
        self.max_coalesce = int(max_coalesce)
        self.stats = ServiceStats(window=stats_window)
        self._queue: Queue = Queue()
        self._expand_memo: dict[ScenarioGrid, list[Scenario]] = {}
        self._expand_limit = 32
        self._closed = False
        self._thread = threading.Thread(target=self._loop,
                                        name="sweep-service", daemon=True)
        self._thread.start()

    # -- client side ---------------------------------------------------
    def submit(self, query: Query | dict) -> QueryTicket:
        """Enqueue a query (a :class:`Query` or a wire document, parsed
        via :func:`parse_query`) and return its ticket immediately."""
        if isinstance(query, dict):
            # probe the workload-table cache BEFORE parsing: grid
            # validation resolves (and therefore caches) the tables, so
            # only a pre-parse probe can see a cold cache.
            workloads = self._workloads_of_doc(query)
            tables_hit = bool(workloads) and all(workload_cached(w)
                                                 for w in workloads)
            query = parse_query(query)
        elif isinstance(query, Query):
            tables_hit = all(workload_cached(w)
                             for w in query.grid.workloads)
        else:
            raise QueryError(f"query must be a Query or a mapping, "
                             f"got {type(query).__name__}")
        if len(query.grid) == 0:
            raise QueryError("zero-scenario grid: every axis needs at "
                             "least one value", code="empty-grid")
        if self._closed:
            raise RuntimeError("service is closed")
        ticket = QueryTicket(query)
        self.stats.record_cache("workload_tables", tables_hit)
        ticket.cache_probe["workload_tables"] = ("hit" if tables_hit
                                                 else "miss")
        self._queue.put(ticket)
        return ticket

    @staticmethod
    def _workloads_of_doc(doc: dict) -> tuple:
        """Best-effort workload names of a not-yet-parsed query doc
        (explicit ``workloads`` key, else the base grid's); used only
        for the pre-parse cache probe, so a wrong guess on a doc that
        parsing will reject anyway is harmless."""
        wl = doc.get("workloads") if isinstance(doc, dict) else None
        if wl is None:
            base = BASE_GRIDS.get(doc.get("grid", "default")) \
                if isinstance(doc, dict) else None
            return base().workloads if base else ()
        if isinstance(wl, str):
            return tuple(p.strip() for p in wl.split(",") if p.strip())
        if isinstance(wl, (list, tuple)):
            return tuple(str(w) for w in wl)
        return ()

    def query(self, query: Query | dict,
              timeout: float | None = None) -> QueryResult:
        """Blocking convenience: ``submit(query).wait(timeout)``."""
        return self.submit(query).wait(timeout)

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def stats_snapshot(self) -> dict:
        return self.stats.snapshot(queue_depth=self._queue.qsize())

    def close(self, timeout: float = 30.0) -> None:
        if not self._closed:
            self._closed = True
            self._queue.put(_Close())
        self._thread.join(timeout)

    def __enter__(self) -> "SweepService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- dispatcher side -----------------------------------------------
    def _loop(self) -> None:
        closing = False
        while not closing:
            try:
                first = self._queue.get(timeout=0.5)
            except Empty:
                continue
            if isinstance(first, _Close):
                break
            batch = [first]
            deadline = time.perf_counter() + self.window_s
            while len(batch) < self.max_coalesce:
                remaining = deadline - time.perf_counter()
                try:
                    item = self._queue.get(
                        timeout=remaining if remaining > 0 else 0,
                        block=remaining > 0)
                except Empty:
                    break
                if isinstance(item, _Close):
                    closing = True
                    break
                batch.append(item)
            self._serve_batch(batch)
        # resolve anything still queued after close
        while True:
            try:
                item = self._queue.get_nowait()
            except Empty:
                return
            if not isinstance(item, _Close):
                item._resolve(error=RuntimeError("service is closed"))

    def _serve_batch(self, batch: list[QueryTicket]) -> None:
        now = time.perf_counter()
        groups: dict[tuple, list[QueryTicket]] = {}
        solo: list[QueryTicket] = []
        for t in batch:
            t.t_dispatch = now
            t.cache_probe["grid_structure"] = self._probe_structure(
                t.query)
            if t.query.coalescable:
                groups.setdefault(t.query.signature, []).append(t)
            else:
                solo.append(t)
        for tickets in groups.values():
            q = tickets[0].query
            self._eval_group(tickets, q.backend, q.seed)
        for t in solo:
            self._eval_group([t], t.query.backend, t.query.seed)

    def _probe_structure(self, q: Query) -> str:
        """Hit/miss probe of the grid-structure memo of the query's
        backend, *before* evaluation touches it (the probe never
        builds or inserts anything).  The memo is exercised directly
        by singleton queries and by anyone re-sweeping the grid;
        coalesced groups rebuild scenario-list axes but share the
        memoized workload tables (probed at submit, pre-parse)."""
        if q.backend == "torch":
            structure = torch_evaluator_cached(q.grid, self.device)
        else:
            structure = evaluator_cached(q.grid)
        self.stats.record_cache("grid_structure", structure)
        return "hit" if structure else "miss"

    def _expand(self, grid: ScenarioGrid) -> list[Scenario]:
        """Memoized ``grid.expand()`` — the coalescer's Python-side
        cost for repeated grids (the axes were validated at parse)."""
        try:
            hit = self._expand_memo.get(grid)
        except TypeError:
            return grid.expand()
        if hit is None:
            if len(self._expand_memo) >= self._expand_limit:
                self._expand_memo.clear()
            hit = self._expand_memo[grid] = grid.expand()
        return hit

    def _eval_group(self, tickets: list[QueryTicket], backend: str,
                    seed: int) -> None:
        """Evaluate one same-signature group with a single kernel call
        and de-multiplex the table back per ticket.  A singleton group
        routes through the memoized grid front end (:func:`sweep`) —
        identical columns, hot structure memos; a larger group
        concatenates the expanded scenario lists through the
        scenario-list kernel, which yields the same columns (bit for bit
        on NumPy; pinned by the tests)."""
        t0 = time.perf_counter()
        try:
            if len(tickets) == 1:
                res = sweep(tickets[0].query.grid, backend=backend,
                            seed=seed,
                            device=self.device if backend == "torch" else None)
                table, elapsed = res.columns, res.elapsed_s
                spans = [(0, len(res))]
            else:
                lists = [self._expand(t.query.grid) for t in tickets]
                spans, lo = [], 0
                for part in lists:
                    spans.append((lo, lo + len(part)))
                    lo += len(part)
                scenarios = [s for part in lists for s in part]
                if backend == "torch":
                    table = eval_scenarios_table_torch(
                        scenarios, seed=seed, device=self.device)
                else:
                    table = eval_scenarios_table(scenarios, seed=seed)
                elapsed = time.perf_counter() - t0
        except Exception as exc:
            err = QueryError(f"evaluation failed: {exc}",
                             code="evaluation-failed")
            for t in tickets:
                self.stats.record_error()
                t._resolve(error=err)
            return
        self.stats.record_kernel(len(tickets), table_len(table), elapsed)
        t_done = time.perf_counter()
        for t, (lo, hi) in zip(tickets, spans):
            sub = slice_table(table, lo, hi)
            n = table_len(sub)
            n_fast, n_tl, n_sim = method_counts(sub)
            wait = t.t_dispatch - t.t_submit
            latency = t_done - t.t_submit
            meta = {
                "n_scenarios": n,
                "elapsed_s": elapsed,
                "scenarios_per_sec": n / elapsed if elapsed else 0.0,
                "n_analytical": n_fast,
                "n_timeline": n_tl,
                "n_simulated": n_sim,
                "backend": backend,
                "qos": {
                    "queue_wait_s": wait,
                    "latency_s": latency,
                    "coalesced_queries": len(tickets),
                    "cache": t.cache_probe,
                },
            }
            assert set(meta) == set(RESULT_META_KEYS) | {"qos"}
            self.stats.record_query(latency, wait)
            t._resolve(QueryResult(table=sub, meta=meta))
