"""Persistent what-if **sweep** server: NDJSON over HTTP, stdlib only.

The port's counterpart of :mod:`repro.launch.serve_sweep`, with
``--device``.  Two servers live under ``repro_torch.launch``:

* :mod:`repro_torch.launch.serve` serves **model inference** (prefill +
  decode over the transformer models): its unit of work is a token.
* :mod:`repro_torch.launch.serve_sweep` (this module) serves **scenario
  sweeps** (what-if queries against the S-SGD DAG model, backed by
  :class:`repro_torch.core.service.SweepService`): its unit of work is a
  scenario grid.  Repeated queries hit process-lifetime caches
  (workload tables, grid-structure memos with their tables on the card)
  and concurrent same-signature queries coalesce into shared kernel
  calls, so a warm query costs milliseconds where a cold one-shot
  ``python -m repro_torch.sweep`` pays imports + table building + the
  copy to the card every time.

    PYTHONPATH=src python -m repro_torch.launch.serve_sweep            # CUDA
    PYTHONPATH=src python -m repro_torch.launch.serve_sweep --device cpu
    curl -s -X POST localhost:8642/query \
        -d '{"grid": "frontier", "workloads": ["resnet50"], "workers": [8]}'

Queries evaluate on ``backend="torch"`` (the default, on ``--device``:
CUDA unless ``cpu``; no GPU is an error) or ``"backend": "numpy"`` (the
host engine, with the event-driven simulator for simulator-only policies).

Protocol (newline-delimited JSON):

* ``POST /query`` — body is one JSON object in the
  :func:`repro_torch.core.service.parse_query` vocabulary (``grid`` plus
  axis overrides plus ``backend``/``seed``), e.g.::

      {"grid": "frontier", "workloads": ["resnet50"], "workers": [8]}

  The response streams NDJSON lines: a ``header`` line (column order,
  scenario count, backend), result chunks, and a ``trailer`` line
  carrying the :data:`repro_torch.core.sweep.RESULT_META_KEYS` metadata plus
  a ``qos`` dict (queue wait, latency, coalesce count, cache probes).
  Result chunks default to **columnar** ``cols`` lines (``{"type":
  "cols", "lo": ..., "cols": {column: [values...]}}`` — roughly half
  the bytes and a fraction of the serialize/parse cost of row dicts);
  a query carrying ``"format": "rows"`` streams tidy per-row dicts
  instead (``{"type": "rows", "rows": [...]}``).  Either way floats
  survive the JSON round trip exactly (``repr`` shortest round-trip),
  so a client rebuilding the table — see :func:`table_from_wire` —
  gets bit-identical columns.
* ``GET /stats`` — one JSON object: the
  :meth:`repro_torch.core.service.ServiceStats.snapshot` QoS document
  (latency percentiles, queue depth, coalesce factor, cache hit
  rates, sustained scenarios/s).
* ``GET /healthz`` — ``{"ok": true}``.

Malformed queries get a structured single-line error document
(HTTP 400, ``{"type": "error", "code": ..., "error": ...}``) — the
same rejections the sweep CLI exits 2 on, never a traceback.  A client
disconnecting mid-stream only ends its own response; the server keeps
serving.
"""
from __future__ import annotations

import argparse
import json
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from repro_torch.core.resulttable import (COLUMNS, _dtype_of, concat_tables,
                                          rows_from_table, slice_table,
                                          table_from_rows)
from repro_torch.core.service import QueryError, SweepService
from repro_torch.core.sweep import RESULT_META_KEYS

#: Rows per result NDJSON line — large enough to amortize JSON
#: overhead, small enough that clients can stream progressively.
ROWS_PER_LINE = 4096

#: Wire formats a query's ``format`` key may select.
FORMATS = ("columns", "rows")


def _json_line(doc: dict) -> bytes:
    return (json.dumps(doc) + "\n").encode()


def table_from_wire(lines: list[dict]) -> dict[str, np.ndarray]:
    """Rebuild the columnar result table from a parsed NDJSON response
    (either wire format) — bit-identical to the server-side table."""
    cols = [l for l in lines if l.get("type") == "cols"]
    if cols:
        return concat_tables([
            {k: np.array(c["cols"][k], dtype=_dtype_of(k))
             for k in COLUMNS} for c in cols])
    return table_from_rows([r for l in lines if l.get("type") == "rows"
                            for r in l["rows"]])


class SweepRequestHandler(BaseHTTPRequestHandler):
    """One HTTP request against the server's shared
    :class:`SweepService`."""

    # HTTP/1.0: the response body ends when the connection closes, so
    # streaming needs no Content-Length / chunked framing.
    protocol_version = "HTTP/1.0"
    server_version = "repro-torch-sweepd/1.0"

    def log_message(self, fmt, *args):  # quiet by default
        if self.server.verbose:  # type: ignore[attr-defined]
            super().log_message(fmt, *args)

    @property
    def service(self) -> SweepService:
        return self.server.service  # type: ignore[attr-defined]

    def _send_json(self, status: int, doc: dict) -> None:
        body = _json_line(doc)
        self.send_response(status)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_error_doc(self, status: int, code: str, message: str) -> None:
        self._send_json(status, {"type": "error", "code": code,
                                 "error": message})

    def do_GET(self) -> None:
        try:
            if self.path == "/stats":
                self._send_json(200, self.service.stats_snapshot())
            elif self.path == "/healthz":
                self._send_json(200, {"ok": True})
            else:
                self._send_error_doc(404, "not-found",
                                     f"no such endpoint {self.path!r}; "
                                     f"POST /query, GET /stats, "
                                     f"GET /healthz")
        except (BrokenPipeError, ConnectionResetError):
            pass

    def do_POST(self) -> None:
        try:
            if self.path != "/query":
                self._send_error_doc(404, "not-found",
                                     f"no such endpoint {self.path!r}; "
                                     f"POST /query")
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(length))
            except (ValueError, TypeError) as e:
                self._send_error_doc(400, "bad-json",
                                     f"request body is not valid JSON: {e}")
                return
            fmt = doc.pop("format", "columns") \
                if isinstance(doc, dict) else "columns"
            if fmt not in FORMATS:
                self._send_error_doc(400, "bad-query",
                                     f"unknown format {fmt!r}; "
                                     f"one of {FORMATS}")
                return
            try:
                ticket = self.service.submit(doc)
                result = ticket.wait(timeout=300.0)
            except QueryError as e:
                self._send_error_doc(400, e.code, str(e))
                return
            except (TimeoutError, RuntimeError) as e:
                self._send_error_doc(503, "unavailable", str(e))
                return
            self._stream_result(result, fmt)
        except (BrokenPipeError, ConnectionResetError):
            # the client went away mid-stream; its query was already
            # evaluated (and counted) — just stop writing to it.
            pass

    def _stream_result(self, result, fmt: str = "columns") -> None:
        table, meta = result.table, result.meta
        n = meta["n_scenarios"]
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()
        self.wfile.write(_json_line({"type": "header",
                                     "columns": list(COLUMNS),
                                     "format": fmt,
                                     "n_scenarios": n,
                                     "backend": meta["backend"]}))
        for lo in range(0, n, ROWS_PER_LINE):
            sub = slice_table(table, lo, min(lo + ROWS_PER_LINE, n))
            if fmt == "rows":
                doc = {"type": "rows", "rows": rows_from_table(sub)}
            else:
                doc = {"type": "cols", "lo": lo,
                       "cols": {k: sub[k].tolist() for k in COLUMNS}}
            self.wfile.write(_json_line(doc))
            self.wfile.flush()
        trailer = {"type": "trailer",
                   **{k: meta[k] for k in RESULT_META_KEYS},
                   "qos": meta["qos"]}
        self.wfile.write(_json_line(trailer))


class SweepServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the shared service; daemon threads
    so a hung client never blocks shutdown."""

    daemon_threads = True

    def __init__(self, address, service: SweepService, *,
                 verbose: bool = False):
        super().__init__(address, SweepRequestHandler)
        self.service = service
        self.verbose = verbose


def make_server(host: str = "127.0.0.1", port: int = 0,
                service: SweepService | None = None,
                window_s: float = 0.005, max_coalesce: int = 32,
                verbose: bool = False, device=None) -> SweepServer:
    """A bound (not yet serving) server — ``port=0`` picks a free port
    (``server.server_address[1]``); the tests and ``chip_smoke.py`` drive
    this directly with ``serve_forever`` on a thread.  Without a
    ``service``, a new one evaluates on ``device`` (CUDA unless ``"cpu"``)."""
    if service is None:
        service = SweepService(window_s=window_s,
                               max_coalesce=max_coalesce, device=device)
    return SweepServer((host, port), service, verbose=verbose)


def _warm(service: SweepService) -> None:
    """Pre-resolve the built-in workload tables and the default grid's
    evaluator so the first real query starts warm."""
    from repro_torch.core.workloads import known_workloads, resolve_workload

    for name in known_workloads():
        resolve_workload(name)
    service.query({"grid": "default"}, timeout=120.0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve_sweep",
        description="Persistent what-if sweep server (NDJSON over HTTP).")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8642)
    p.add_argument("--window-ms", type=float, default=5.0,
                   help="micro-batch coalescing window (0 disables)")
    p.add_argument("--max-coalesce", type=int, default=32,
                   help="max queries fused into one kernel call")
    p.add_argument("--device", default=None,
                   help="device of backend='torch' queries: cuda (default; "
                        "an error without a GPU) or cpu")
    p.add_argument("--no-warm", action="store_true",
                   help="skip startup cache warming")
    p.add_argument("--verbose", action="store_true",
                   help="log each request")
    args = p.parse_args(argv)

    try:
        service = SweepService(window_s=args.window_ms / 1e3,
                               max_coalesce=args.max_coalesce,
                               device=args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not args.no_warm:
        print("warming caches (workload tables + default grid) ...",
              file=sys.stderr)
        _warm(service)
    server = make_server(args.host, args.port, service=service,
                         verbose=args.verbose)
    host, port = server.server_address[:2]
    print(f"serving sweeps on http://{host}:{port} ({service.device})  "
          f"(POST /query, GET /stats; Ctrl-C to stop)", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
