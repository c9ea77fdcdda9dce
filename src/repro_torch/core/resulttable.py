"""Columnar result tables: the tidy-results schema as NumPy columns.

A copy of :mod:`repro.core.resulttable`.

The sweep pipeline's result unit is a **table** — a dict mapping each
:data:`COLUMNS` key to one ``(n,)`` NumPy array (object arrays for the
label columns, ``int64``/``float64`` for the numeric ones).  Tables
flow straight out of the batched kernels
(:meth:`repro_torch.core.batched.GridRun.table_slice`,
:meth:`repro_torch.core.batched_torch.TorchGridRun.table_slice`), through the parallel
execution layer (:mod:`repro_torch.core.parallel`) and into
:class:`repro_torch.core.sweep.SweepResult` without ever materializing a
``list[dict]`` on the hot path; per-row dicts are a *view* built on
demand by :func:`rows_from_table` (``.tolist()`` converts whole
columns to Python scalars in C, so even the compat view never loops
per value in Python).

This module is a leaf — :mod:`repro_torch.core.batched`,
:mod:`repro_torch.core.batched_torch` and :mod:`repro_torch.core.sweep` all import
the schema from here, which is what lets the kernel emit result
columns directly without a circular import.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

#: Column order of the tidy results table (the single source of truth;
#: :mod:`repro_torch.core.sweep` re-exports it).  ``het`` / ``straggler``
#: are the heterogeneity axes (label ``"none"`` when unused);
#: ``sync_k`` / ``faults`` the failure-model axes (``sync_k = 0`` means
#: full synchronization, a positive K means the iteration waits for the
#: first K of N gradients; ``faults`` is the ``fail:`` spec label,
#: ``"none"`` when unused); ``t_mean_s``/``t_p95_s``/``t_p99_s`` are
#: the Monte Carlo tail statistics of the iteration time — equal to
#: ``iteration_time_s`` on deterministic rows (a point mass has no
#: tails).
COLUMNS = ("workload", "cluster", "n_workers", "policy", "collective",
           "interconnect", "het", "straggler", "sync_k", "faults",
           "batch_per_gpu",
           "iteration_time_s", "samples_per_sec", "speedup",
           "t_comm_s", "t_comp_s", "t_mean_s", "t_p95_s", "t_p99_s",
           "method")

#: String-valued columns, stored as object arrays (shared-pointer
#: labels: fancy-indexing an object array copies references, never
#: string bytes).
LABEL_COLUMNS = ("workload", "cluster", "policy", "collective",
                 "interconnect", "het", "straggler", "faults", "method")

#: Integer-valued columns (int64).
INT_COLUMNS = ("n_workers", "sync_k", "batch_per_gpu")

#: Float-valued columns (float64).
FLOAT_COLUMNS = ("iteration_time_s", "samples_per_sec", "speedup",
                 "t_comm_s", "t_comp_s", "t_mean_s", "t_p95_s",
                 "t_p99_s")

#: Evaluation-path labels indexed by the policy tier code the batched
#: select computes (0 = closed form, 1 = bucket timeline, 2 =
#: event-driven simulator).
METHOD_LABELS = np.array(["analytical", "timeline", "simulated"],
                         dtype=object)


def _dtype_of(column: str):
    if column in LABEL_COLUMNS:
        return object
    if column in INT_COLUMNS:
        return np.int64
    return np.float64


def empty_table() -> dict[str, np.ndarray]:
    """A zero-row table with the canonical dtypes."""
    return {k: np.empty(0, dtype=_dtype_of(k)) for k in COLUMNS}


def table_from_rows(rows: Sequence[dict]) -> dict[str, np.ndarray]:
    """Columnar table from tidy row dicts (the per-scenario reference
    paths still produce rows; everything downstream speaks tables)."""
    if not rows:
        return empty_table()
    return {k: np.array([r[k] for r in rows], dtype=_dtype_of(k))
            for k in COLUMNS}


def concat_tables(tables: Sequence[dict]) -> dict[str, np.ndarray]:
    """Concatenate chunk tables in order into one table."""
    tables = [t for t in tables if len(next(iter(t.values())))]
    if not tables:
        return empty_table()
    if len(tables) == 1:
        return tables[0]
    return {k: np.concatenate([t[k] for t in tables]) for k in COLUMNS}


def table_len(table: dict) -> int:
    return len(table["workload"])


def slice_table(table: dict, lo: int, hi: int) -> dict[str, np.ndarray]:
    """Row slice ``[lo, hi)`` of a table, as column **views** (NumPy
    basic slicing — no bytes copied): how the sweep service
    de-multiplexes one coalesced kernel table back into per-query
    results."""
    return {k: table[k][lo:hi] for k in COLUMNS}


def rows_from_table(table: dict,
                    indices: np.ndarray | None = None) -> list[dict]:
    """Tidy row dicts from a table — the compat view.  ``indices``
    selects (and orders) a subset of rows; ``None`` takes the whole
    table in order."""
    def col(k):
        c = table[k] if indices is None else table[k][indices]
        return c.tolist()

    return [dict(zip(COLUMNS, values))
            for values in zip(*(col(k) for k in COLUMNS))]


def fill_rows(table: dict, indices: Sequence[int],
              rows: Sequence[dict]) -> None:
    """Overwrite ``table``'s rows at ``indices`` with ``rows`` in
    place (the simulator-fallback interleave)."""
    idx = np.asarray(list(indices), dtype=np.int64)
    for k in COLUMNS:
        table[k][idx] = np.array([r[k] for r in rows], dtype=_dtype_of(k))


def method_counts(table: dict) -> tuple[int, int, int]:
    """``(n_analytical, n_timeline, n_simulated)`` from the method
    column."""
    m = table["method"]
    n_fast = int(np.count_nonzero(m == "analytical"))
    n_tl = int(np.count_nonzero(m == "timeline"))
    return n_fast, n_tl, len(m) - n_fast - n_tl
