"""Agreement checks between the sweep's paths, shared by the CPU tests and
``chip_smoke.py``: result tables against each other (labels exact, numbers
within a relative bound), a streamed CSV against :func:`sweep`, the
event-driven simulator's rows of a grid (split into sub-grids that may run
on a process pool), and a client of the sweep server.

The bounds are the reference suite's: the batched backends agree with the
NumPy engine and with the simulator to <= 1e-6 relative
(:data:`BATCHED_RTOL`); a query coalesced on the card agrees with a direct
sweep on the card bit for bit or, where CUDA reduces in another order, to
<= 1e-12 relative (:data:`COALESCED_RTOL`).
"""
from __future__ import annotations

import csv
import itertools
import json
import os
import pickle
import subprocess
import sys
import tempfile
import urllib.request
from dataclasses import replace

import numpy as np

from repro_torch.core import parallel
from repro_torch.core.resulttable import (COLUMNS, LABEL_COLUMNS, _dtype_of,
                                          concat_tables, table_len)
from repro_torch.core.scenarios import ScenarioGrid, grid_from_spec
from repro_torch.core.sweep import stream_csv, sweep

#: The batched backends against the NumPy engine, and the batched rows
#: against the event-driven simulator.
BATCHED_RTOL = 1e-6
#: A coalesced query against a direct sweep on the same device.
COALESCED_RTOL = 1e-12
#: Absolute floor of every comparison (columns that are exactly 0).
ATOL = 1e-12
#: The columns a batched row and the simulator's row of one scenario share:
#: its times.  ``t_comm_s`` / ``t_comp_s`` are the unscaled per-layer sums
#: on the simulator's path and ``method`` names the path.
ORACLE_COLUMNS = ("iteration_time_s", "samples_per_sec", "speedup",
                  "t_mean_s", "t_p95_s", "t_p99_s")
_FLOAT = tuple(k for k in COLUMNS if _dtype_of(k) is np.float64)


def worst_relative(got: dict, want: dict, oracle: bool = False) -> float:
    """Largest relative difference over the float columns of two tables of
    equal length (:data:`ORACLE_COLUMNS` only when ``oracle``); raises
    ``AssertionError`` unless every other column is equal (``method``
    aside when ``oracle``)."""
    n = table_len(want)
    assert table_len(got) == n, (table_len(got), n)
    floats = ORACLE_COLUMNS if oracle else _FLOAT
    worst = 0.0
    for k in COLUMNS:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if k in floats:
            if n:
                den = np.maximum(np.abs(b), np.finfo(np.float64).tiny)
                worst = max(worst, float(np.max(np.abs(a - b) / den)))
        elif k not in _FLOAT and not (oracle and k == "method"):
            assert a.tolist() == b.tolist(), k
    return worst


def assert_tables_agree(got: dict, want: dict, rtol: float,
                        oracle: bool = False) -> float:
    """Labels equal, every float column (:data:`ORACLE_COLUMNS` when
    ``oracle``: ``want`` is the simulator's) within ``rtol`` relative and
    :data:`ATOL` absolute; returns :func:`worst_relative`."""
    worst = worst_relative(got, want, oracle)
    for k in ORACLE_COLUMNS if oracle else _FLOAT:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=ATOL,
                                   err_msg=k)
    return worst


def bit_identical(got: dict, want: dict) -> bool:
    return all(np.array_equal(got[k], want[k]) for k in COLUMNS)


def query_grid(doc: dict) -> ScenarioGrid:
    """The grid of a sweep-service query document."""
    return grid_from_spec({k: v for k, v in doc.items()
                           if k not in ("backend", "seed", "format")})


def direct_table(doc: dict, backend: str, device=None) -> dict:
    """What a direct :func:`sweep` of a query's grid returns on
    ``backend`` (``device`` for ``"torch"``)."""
    return sweep(query_grid(doc), backend=backend, seed=doc.get("seed", 0),
                 device=device if backend == "torch" else None).columns


def read_csv_table(path) -> dict:
    """A streamed CSV read back into a columnar table: every float written
    by ``repr`` round-trips exactly."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        assert tuple(header) == COLUMNS, header
        rows = list(reader)
    cols = list(zip(*rows)) if rows else [()] * len(COLUMNS)
    # NumPy parses the decimal strings itself (shortest repr round-trips)
    return {k: np.array(values, dtype=_dtype_of(k))
            for k, values in zip(COLUMNS, cols)}


def stream_matches_sweep(grid: ScenarioGrid, path, *, chunk: int,
                         backend: str = "torch", device=None,
                         seed: int = 0) -> dict:
    """Stream ``grid`` to a CSV at ``path`` in chunks of ``chunk`` and
    check that the rows read back equal :func:`sweep`'s bit for bit.
    Returns the stream's metadata with ``n_chunks`` added."""
    meta = stream_csv(grid, path, chunk=chunk, backend=backend,
                      device=device, seed=seed)
    want = sweep(grid, backend=backend, device=device, seed=seed).columns
    assert bit_identical(read_csv_table(path), want)
    return {**meta, "n_chunks": -(-table_len(want) // chunk)}


def _simulated_span(grid: ScenarioGrid, warm_iterations: int,
                    seed: int) -> dict:
    return sweep(grid, backend="numpy", force_simulator=True,
                 warm_iterations=warm_iterations, seed=seed).columns


def simulated_table(grid: ScenarioGrid, *, jobs: int = 1,
                    warm_iterations: int = 6, seed: int = 0) -> dict:
    """``sweep(grid, backend="numpy", force_simulator=True)``'s table,
    evaluated as one sub-grid per (workload, cluster, workers, policy).
    Those are the grid's four outermost axes, so the sub-grids' tables,
    concatenated in that order, are the grid's rows in grid order.  With
    ``jobs > 1`` they run on a spawned process pool of a fresh interpreter
    whose main module is this one (``python -m repro_torch.core.agreement``):
    a worker spawned from the caller would import the caller's main module
    first, which for ``chip_smoke.py`` means torch and CUDA."""
    subs = [replace(grid, workloads=(w,), clusters=(c,), worker_counts=(n,),
                    policies=(p,))
            for w, c, n, p in itertools.product(
                grid.workloads, grid.clusters, grid.worker_counts,
                grid.policies)]
    if jobs <= 1:
        return concat_tables([_simulated_span(s, warm_iterations, seed)
                              for s in subs])
    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump((subs, jobs, warm_iterations, seed), f)
        path = os.pathsep.join(filter(None, (parallel._SRC_PATH,
                                             os.environ.get("PYTHONPATH"))))
        subprocess.run([sys.executable, "-m", "repro_torch.core.agreement", job],
                       check=True, env={**os.environ, "PYTHONPATH": path})
        with open(job, "rb") as f:
            return pickle.load(f)


def _pool_main(job: str) -> int:
    """Evaluate the pickled sub-grids of :func:`simulated_table` on a spawned
    pool and write their concatenated table over the job file."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    with open(job, "rb") as f:
        subs, jobs, warm_iterations, seed = pickle.load(f)
    with ProcessPoolExecutor(max_workers=jobs,
                             mp_context=mp.get_context("spawn"),
                             initializer=parallel._init_worker,
                             initargs=(parallel._SRC_PATH,)) as ex:
        table = concat_tables(list(ex.map(
            _simulated_span, subs, itertools.repeat(warm_iterations),
            itertools.repeat(seed))))
    with open(job, "wb") as f:
        pickle.dump(table, f)
    return 0


def http_query(port: int, doc: dict, host: str = "127.0.0.1") -> list[dict]:
    """POST one query to a sweep server on this host; the parsed NDJSON
    lines of its answer."""
    req = urllib.request.Request(f"http://{host}:{port}/query",
                                 data=json.dumps(doc).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return [json.loads(line) for line in resp]


def http_get(port: int, path: str, host: str = "127.0.0.1") -> dict:
    with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read())


if __name__ == "__main__":
    sys.exit(_pool_main(sys.argv[1]))
