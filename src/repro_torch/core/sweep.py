"""Batched scenario sweep of the S-SGD DAG model: the port's counterpart
of :mod:`repro.core.sweep`, for the batched paths only.

:func:`sweep` evaluates a :class:`~repro_torch.core.scenarios.ScenarioGrid`
(or a list of scenarios) through one of two batched engines and returns
the reference's tidy columnar table (:data:`COLUMNS`) with its
``n_analytical`` / ``n_timeline`` / ``n_simulated`` accounting:

* ``backend="torch"`` (the default): the two tiers on the card in float64
  (:mod:`repro_torch.core.batched_torch`); ``device`` is CUDA unless
  ``"cpu"`` is asked for, and asking for CUDA without a GPU raises;
* ``backend="numpy"``: the port's copy of the NumPy engine
  (:mod:`repro_torch.core.batched`), equal to the reference's bit for bit.

Closed-form policies come back as ``method="analytical"`` rows,
bucketed/priority policies as ``method="timeline"`` rows.  The port has no
event-driven simulator rows, no per-scenario reference path, no worker
pool and no streaming: a grid or list holding a policy with neither batched
form raises ``ValueError`` on either backend, as the reference's
``backend="jax"`` does, so ``n_simulated`` is always 0.
"""
from __future__ import annotations

import csv
import json
import time
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core import het as het_mod
from repro_torch.core.batched import eval_scenarios_table, grid_evaluator
from repro_torch.core.batched_torch import (eval_scenarios_table_torch,
                                            require_all_batched,
                                            torch_grid_evaluator)
from repro_torch.core.resulttable import (COLUMNS, empty_table,
                                          method_counts, rows_from_table,
                                          table_len)
from repro_torch.core.scenarios import (Scenario, ScenarioGrid,
                                        normalize_interconnect,
                                        normalize_sync_k)

#: Evaluation backends :func:`sweep` accepts: the two tiers on the card
#: (the default) and the port's copy of the NumPy engine.
BACKENDS = ("torch", "numpy")

#: Metadata keys of :meth:`SweepResult.meta` (the reference's
#: ``RESULT_META_KEYS``).
RESULT_META_KEYS = ("n_scenarios", "elapsed_s", "scenarios_per_sec",
                    "n_analytical", "n_timeline", "n_simulated", "backend")


@dataclass
class SweepResult:
    """Tidy results table, stored **columnar**: ``columns`` maps each
    :data:`COLUMNS` key to one ``(n,)`` NumPy array.  :attr:`rows` is the
    lazy per-row view.  ``n_analytical`` counts closed-form rows,
    ``n_timeline`` bucket-timeline rows and ``n_simulated`` simulator rows
    (always 0 here); ``backend`` records which engine produced the rows."""

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


def _check_backend(backend: str, device) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "numpy" and device is not None:
        raise ValueError(f"backend='numpy' runs on the host; device={device!r} "
                         f"applies to backend='torch' only")


def sweep(grid: ScenarioGrid | Iterable[Scenario], *,
          backend: str = "torch", device=None, seed: int = 0) -> SweepResult:
    """Evaluate every scenario of ``grid`` and return the tidy table.

    A :class:`ScenarioGrid` is evaluated whole by the backend's grid
    evaluator, a scenario list whole by its list front end.
    ``backend="torch"`` runs the two tiers on ``device`` (CUDA unless
    ``"cpu"``); ``backend="numpy"`` the port's NumPy engine.  ``seed`` keys
    the straggler and fault draws; the same grid and seed give the same
    tail columns on both backends."""
    _check_backend(backend, device)
    t0 = time.perf_counter()
    if isinstance(grid, ScenarioGrid):
        if backend == "torch":
            run = torch_grid_evaluator(grid, device=device).run(seed=seed)
        else:
            ev = grid_evaluator(grid)
            require_all_batched(ev, backend)
            run = ev.run(seed=seed)
        columns = run.table_slice(0, len(run))[0]
        elapsed = time.perf_counter() - t0
        ev = grid_evaluator(grid)
        n_fast, n_tl = ev.n_fast, ev.n_timeline
    else:
        scenarios = list(grid)
        for s in scenarios:
            s.validate()
        if not scenarios:
            columns = empty_table()
        elif backend == "torch":
            columns = eval_scenarios_table_torch(scenarios, seed=seed, device=device)
        else:
            columns = eval_scenarios_table(scenarios, seed=seed)
        elapsed = time.perf_counter() - t0
        n_fast, n_tl, _ = method_counts(columns)
    return SweepResult(columns=columns, elapsed_s=elapsed,
                       n_analytical=n_fast, n_timeline=n_tl,
                       n_simulated=0, backend=backend)
