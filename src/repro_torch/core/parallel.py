"""Sharded sweep execution: grid chunks across a worker pool.

A copy of :mod:`repro.core.parallel`, for the port's NumPy backend.

The batched kernel already evaluates tens of thousands of scenarios per
core-millisecond, so the parallel layer's job is **not** to make one
chunk faster — it is to let a grid sweep use more than one core without
changing a single output bit.  The design that makes that trivial:

* A :class:`~repro_torch.core.scenarios.ScenarioGrid` is a tiny frozen
  value object, and every per-scenario quantity is *derived* from the
  flat index (rightmost axis fastest).  A unit of work is therefore
  just ``(grid, lo, hi)`` — no arrays cross the process boundary on
  the way in, and the grid pickles in microseconds.
* :meth:`repro_torch.core.batched.GridEvaluator.run_span` restricts the
  kernel to the unique kernel points a span touches, so a worker
  evaluating 1/Nth of the grid does ~1/Nth of the kernel work — the
  memoized evaluator (grid structure, workload tables, bucket tables)
  is built once per worker process and shared by all its spans.
* Workers return columnar tables (:mod:`repro_torch.core.resulttable`):
  one pickled NumPy array per column, not N dicts.
* Chunking is deterministic and results are yielded **in submission
  order**, so ``jobs=N`` output is bit-identical to serial — the
  kernel is pure elementwise arithmetic per scenario point, and
  chunk boundaries cannot change any value
  (the tests pin exact equality).

``pool="process"`` (default) uses a spawn-context
``ProcessPoolExecutor`` — fork is unsafe with threaded BLAS and any
CUDA runtime in the parent.  ``pool="thread"`` runs the spans on
threads instead: zero startup cost and useful concurrency because the
kernel spends its time inside NumPy (GIL released), but processes are
the honest default for CPU-bound sharding.  Pools are cached per
``(kind, jobs)`` and shut down at interpreter exit; a cached pool that
broke (a worker OOM-killed or segfaulted) is evicted and rebuilt on
the next request instead of poisoning every later sweep.

Execution is **crash-tolerant**: a span whose worker process dies
(``BrokenProcessPool``) is retried on a freshly built pool with
exponential backoff, and a span that keeps killing workers — a poison
span — is isolated and rescued in the parent process (whole-span
first, then scenario by scenario, finally raising an error that names
the offending flat-index range).  Because every span is a pure
function of ``(grid, lo, hi, seed)``, re-running it cannot change a
bit: a sweep that loses a worker finishes with output bit-identical
to the serial evaluation (the tests kill a live worker
mid-sweep and pin exact equality).

The torch backend does **not** use this module: it evaluates on one
card, where a host pool has nothing to shard, so ``jobs`` is a no-op there
(:func:`repro_torch.core.sweep.iter_tables`).  The workers import
:mod:`repro_torch.core` only, which imports no ``torch``, so a spawned
worker stays as light as the reference's.
"""
from __future__ import annotations

import atexit
import os
import sys
import time
from concurrent.futures import BrokenExecutor, Executor, \
    ProcessPoolExecutor, ThreadPoolExecutor
from typing import Iterator

import numpy as np

from repro_torch.core.scenarios import ScenarioGrid

#: ``sys.path`` entry the workers need to import :mod:`repro_torch` — spawned
#: interpreters inherit neither ``PYTHONPATH`` mutations made after
#: startup nor the parent's ``sys.path``.
_SRC_PATH = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

POOL_KINDS = ("process", "thread")


def resolve_jobs(jobs: int | None) -> int:
    """Worker count for a ``jobs`` argument: ``None``/``0``/``1`` mean
    serial, a negative value means one worker per available core."""
    if not jobs or jobs == 1:
        return 1
    if jobs < 0:
        return os.cpu_count() or 1
    return int(jobs)


def span_plan(n: int, jobs: int, chunk: int) -> list[tuple[int, int]]:
    """Contiguous ``(lo, hi)`` spans covering ``[0, n)``: at least
    ``chunk`` scenarios each (a span below kernel-chunk size wastes the
    fixed per-call cost), at most ``4 * jobs`` spans total (enough
    slack to even out simulator-fallback stragglers without drowning
    in per-span overhead)."""
    if n == 0:
        return []
    span = max(chunk, -(-n // (jobs * 4)))
    return [(lo, min(lo + span, n)) for lo in range(0, n, span)]


#: Workload schemes whose tables every spawned worker pre-resolves in
#: its initializer: the built-in Table-IV CNN tables — the workloads of
#: the default and frontier grids, cheap to build and file-free.
#: (``trace:``/``llm:``/``torch:`` tables keep resolving lazily on first
#: use; preloading them would mean file I/O and archcost slicing for
#: sweeps that may never touch them.)
PRELOAD_SCHEMES = ("cnn",)


def _init_worker(src_path: str, preload: bool = True) -> None:
    """Spawned-worker initializer: make ``repro_torch`` importable, then
    pre-pay the preparation a cold span would otherwise pay inside its
    first evaluation — import the evaluation stack (sweep engine,
    batched kernels, workload registry) and resolve the built-in
    workload tables (:data:`PRELOAD_SCHEMES`).  Preloading is
    opportunistic: any failure leaves the worker lazy, exactly as
    before."""
    if src_path not in sys.path:
        sys.path.insert(0, src_path)
    if not preload:
        return
    try:
        from repro_torch.core import batched, sweep  # noqa: F401
        from repro_torch.core.workloads import WORKLOAD_PROVIDERS, resolve_workload

        for scheme in PRELOAD_SCHEMES:
            provider = WORKLOAD_PROVIDERS.get(scheme)
            for name in provider.names() if provider else ():
                resolve_workload(f"{scheme}:{name}")
    except Exception:               # pragma: no cover - best effort
        pass


def _eval_span(grid: ScenarioGrid, lo: int, hi: int,
               warm_iterations: int, seed: int = 0) -> dict:
    """One unit of work: evaluate flat scenario indices ``[lo, hi)``
    and return the finished columnar table.  Runs in the worker; the
    evaluator memo (:func:`repro_torch.core.batched.grid_evaluator`) makes
    every span after a worker's first reuse the prepared structure.
    ``seed`` keys the straggler Monte Carlo draws — the draws are keyed
    by ``(spec, n_workers, seed)`` alone, so sharding cannot change a
    single sample."""
    from repro_torch.core.batched import grid_evaluator

    ev = grid_evaluator(grid)
    table, batched = ev.run_span(lo, hi, seed=seed)
    if not bool(batched.all()):
        # simulator-fallback rows are filled where they are computed,
        # so the parent never re-derives which rows a span left bogus
        from repro_torch.core.resulttable import fill_rows
        from repro_torch.core.sweep import _sim_eval

        idx = np.nonzero(~batched)[0]
        fill_rows(table, idx,
                  [_sim_eval(ev.scenario_at(lo + int(i)), warm_iterations,
                             seed=seed)
                   for i in idx])
    return table


_POOLS: dict[tuple[str, int], Executor] = {}

#: Pool rebuilds :func:`parallel_tables` pays for worker-process deaths
#: before treating the failing span as poison and rescuing it in the
#: parent.
MAX_POOL_REBUILDS = 3

#: First-retry backoff after a worker death; doubles per rebuild.
RETRY_BACKOFF_S = 0.05


def _evict_pool(ex: Executor) -> None:
    """Drop ``ex`` from the cache (if present) and shut it down — a
    broken executor rejects every future submit, so keeping it cached
    would poison all later sweeps."""
    for key, pool in list(_POOLS.items()):
        if pool is ex:
            del _POOLS[key]
    ex.shutdown(wait=False, cancel_futures=True)


def _get_pool(kind: str, jobs: int) -> Executor:
    if kind not in POOL_KINDS:
        raise ValueError(f"unknown pool {kind!r}; one of {POOL_KINDS}")
    key = (kind, jobs)
    pool = _POOLS.get(key)
    if pool is not None and getattr(pool, "_broken", False):
        # a worker died since the last sweep (OOM killer, segfault):
        # the executor is permanently broken — rebuild instead of
        # handing the corpse to every future caller
        _evict_pool(pool)
        pool = None
    if pool is None:
        if kind == "process":
            import multiprocessing as mp

            pool = ProcessPoolExecutor(
                max_workers=jobs, mp_context=mp.get_context("spawn"),
                initializer=_init_worker, initargs=(_SRC_PATH,))
        else:
            pool = ThreadPoolExecutor(max_workers=jobs)
        _POOLS[key] = pool
    return pool


def warm_pool(kind: str = "process", jobs: int = 2) -> None:
    """Build (or fetch) the cached pool for ``(kind, jobs)`` and block
    until every worker has spawned and run its initializer — the
    pre-import/pre-resolve of :func:`_init_worker` included — so the
    *first* ``sweep(jobs=N)`` pays no per-worker preparation inside its
    spans.  The sweep server calls this at startup; benchmarks call it
    to separate cold-start cost from steady-state throughput.

    One short parked task per worker forces the executor's lazy spawn
    to reach all ``jobs`` processes (tasks that return instantly would
    all land on the first worker)."""
    jobs = resolve_jobs(jobs)
    if jobs <= 1:
        return
    ex = _get_pool(kind, jobs)
    for f in [ex.submit(time.sleep, 0.05) for _ in range(jobs)]:
        f.result()


@atexit.register
def _shutdown_pools() -> None:
    for pool in _POOLS.values():
        pool.shutdown(wait=False, cancel_futures=True)
    _POOLS.clear()


def _rescue_span(grid: ScenarioGrid, lo: int, hi: int,
                 warm_iterations: int, seed: int) -> dict:
    """In-parent rescue for a poison span: evaluate ``[lo, hi)`` whole;
    if that raises, fall back scenario by scenario so a single bad
    point is named by its flat index instead of taking the span's other
    scenarios down with it."""
    from repro_torch.core.resulttable import concat_tables

    try:
        return _eval_span(grid, lo, hi, warm_iterations, seed)
    except Exception:
        tables = []
        for i in range(lo, hi):
            try:
                tables.append(
                    _eval_span(grid, i, i + 1, warm_iterations, seed))
            except Exception as exc:
                raise RuntimeError(
                    f"scenario at flat index {i} of poison span "
                    f"[{lo}, {hi}) failed even in-process: {exc}") from exc
        return concat_tables(tables)


def parallel_tables(grid: ScenarioGrid, *, jobs: int,
                    chunk: int, warm_iterations: int = 6,
                    pool: str | Executor = "process",
                    seed: int = 0) -> Iterator[dict]:
    """Evaluate ``grid`` sharded across ``jobs`` workers, yielding
    finished columnar tables **in grid order** (submission order; all
    spans are in flight at once, results are consumed as each earliest
    outstanding span completes).  ``pool`` is ``"process"`` /
    ``"thread"`` or any ``concurrent.futures.Executor`` to reuse;
    ``seed`` keys the straggler Monte Carlo draws identically in every
    worker.

    A dying worker process (``BrokenProcessPool``) does not kill the
    sweep: the broken pool is evicted from the cache, a fresh one is
    built after an exponential backoff, and every not-yet-yielded span
    is resubmitted — spans are pure functions of ``(grid, lo, hi,
    seed)``, so the retried output is bit-identical.  After
    :data:`MAX_POOL_REBUILDS` (or a span that breaks two pools in a
    row — a poison span) the failing span is rescued in the parent via
    :func:`_rescue_span`, naming the offending flat-index range if it
    cannot be salvaged at all.  A caller-supplied executor is never
    rebuilt: the ``BrokenExecutor`` propagates, because replacing a
    pool this function does not own would be a lie."""
    jobs = resolve_jobs(jobs)
    n = len(grid)
    spans = span_plan(n, jobs, chunk)
    if not spans:
        return
    if jobs == 1:
        for lo, hi in spans:
            yield _eval_span(grid, lo, hi, warm_iterations, seed)
        return
    external = isinstance(pool, Executor)
    ex = pool if external else _get_pool(pool, jobs)

    def submit_from(start: int) -> None:
        futures[start:] = [
            ex.submit(_eval_span, grid, lo, hi, warm_iterations, seed)
            for lo, hi in spans[start:]]

    futures: list = [None] * len(spans)
    submit_from(0)
    rebuilds = 0
    breaks: dict[int, int] = {}        # span index -> pools it broke
    i = 0
    while i < len(spans):
        lo, hi = spans[i]
        try:
            table = futures[i].result()
        except BrokenExecutor:
            if external:
                raise
            breaks[i] = breaks.get(i, 0) + 1
            _evict_pool(ex)
            if rebuilds >= MAX_POOL_REBUILDS or breaks[i] > 1:
                # poison span (or the machine keeps killing workers):
                # rescue this span in the parent, then let the rest of
                # the sweep continue on a fresh pool
                table = _rescue_span(grid, lo, hi, warm_iterations, seed)
                ex = _get_pool(pool, jobs)
                submit_from(i + 1)
            else:
                rebuilds += 1
                time.sleep(RETRY_BACKOFF_S * 2 ** (rebuilds - 1))
                ex = _get_pool(pool, jobs)
                submit_from(i)
                continue
        yield table
        i += 1
