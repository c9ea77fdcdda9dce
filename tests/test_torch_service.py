"""The port's sweep service and its HTTP server
(``repro_torch.core.service``, ``repro_torch.launch.serve_sweep``) against
the reference's (``repro.core.service``, ``repro.launch.serve_sweep``) on
the same queries: ``parse_query``'s rejections and codes equal, the
served tables bit for bit equal to the reference service's and to a direct
sweep on NumPy, and on the torch backend (here on the CPU) coalesced
queries bit for bit equal to a direct torch sweep — what the CPU's
reductions give; ``chip_smoke.py`` finds out what CUDA's give.  Coalescing
is made deterministic by a long batch window: every query of a group is
submitted before the window closes."""
import json
import socket
import threading
import urllib.error
import urllib.request

import pytest
import torch

from repro.core import service as rservice
from repro.launch import serve_sweep as rserve
from repro_torch.core import agreement as A
from repro_torch.core import batched as tbatched
from repro_torch.core import batched_torch as BT
from repro_torch.core import workloads as tworkloads
from repro_torch.core.resulttable import COLUMNS, table_from_rows
from repro_torch.core.service import QueryError, SweepService, parse_query
from repro_torch.core.sweep import RESULT_META_KEYS
from repro_torch.launch import serve_sweep

CPU = "cpu"

# Heterogeneous same-depth queries: one kernel signature each (seed 7).
COALESCE_SPECS = [
    {"workloads": ["resnet50"], "workers": [4, 8], "seed": 7},
    {"grid": "mixed", "workloads": ["resnet50"], "workers": [8], "seed": 7},
    {"workloads": ["resnet50"], "workers": [4], "het": ["het:1x0.5+3x1.0"],
     "seed": 7},
    {"workloads": ["resnet50"], "workers": [16], "sync_k": ["none", "3"],
     "stragglers": ["none", "lognormal:0.2x8"], "faults": ["none", "fail:0.1x8"],
     "seed": 7},
]


def assert_identical(got: dict, want: dict):
    assert A.bit_identical(got, want) and len(got["workload"]) > 0


def served(specs, backend, service=rservice.SweepService, **kw):
    """Every spec through one service, submitted inside one long window;
    (tables, stats snapshot)."""
    with service(window_s=0.5, max_coalesce=16, **kw) as svc:
        tickets = [svc.submit({**s, "backend": backend}) for s in specs]
        results = [t.wait(timeout=120) for t in tickets]
        return results, svc.stats_snapshot()


class TestParseQuery:
    @pytest.mark.parametrize("doc", [
        {"grid": "nope"}, {"bogus": 1}, {"backend": "tpu"}, {"seed": "x"},
        {"seed": True}, {"workloads": []}, {"workloads": ["no-such-net"]},
        {"sync_k": ["-3"]}, {"policies": ["no-such-policy"]},
        {"stragglers": ["weird:1"]}, {"faults": ["fail:2"]}, ["not", "a", "dict"],
        {"het": ["het:0x1"]}, {"workers": []},
    ], ids=repr)
    def test_rejections_equal_the_reference(self, doc):
        with pytest.raises(QueryError) as ours:
            parse_query(doc)
        with pytest.raises(rservice.QueryError) as theirs:
            rservice.parse_query(doc)
        assert ours.value.code == theirs.value.code
        msg, ref_msg = str(ours.value), str(theirs.value)
        if "backend" not in msg:
            assert msg == ref_msg.replace("repro.", "repro_torch.")

    def test_backends(self):
        q = parse_query({"workloads": ["resnet50"], "workers": [4]})
        assert (q.backend, q.seed, q.coalescable) == ("torch", 0, True)
        assert parse_query({"backend": "numpy"}).backend == "numpy"
        with pytest.raises(QueryError, match="unknown backend 'jax'") as ei:
            parse_query({"backend": "jax"})
        assert ei.value.code == "bad-query"

    def test_signature_carries_padded_depth(self):
        for backend in ("torch", "numpy"):
            qa = parse_query({"workloads": ["resnet50"], "workers": [4], "backend": backend})
            qb = parse_query({"workloads": ["alexnet"], "workers": [4], "backend": backend})
            assert qa.signature[:2] == qb.signature[:2] == (backend, 0)
            assert qa.signature[2] != qb.signature[2]
            assert qa.signature[1:] == rservice.parse_query(
                {"workloads": ["resnet50"], "workers": [4]}).signature[1:]

    def test_simulator_only_policies(self):
        from repro.core import policies as rpol
        from repro_torch.core import policies as tpol

        pol = dict(name="_simonly", overlap_io=False, overlap_comm=True, bucket_bytes=25e6)
        tpol.ALL_POLICIES["_simonly"] = tpol.Policy(**pol)
        rpol.ALL_POLICIES["_simonly"] = rpol.Policy(**pol)
        try:
            doc = {"workloads": ["alexnet"], "workers": [2], "policies": ["_simonly"]}
            with pytest.raises(QueryError, match="backend='numpy'"):
                parse_query(doc)
            assert not parse_query({**doc, "backend": "numpy"}).coalescable
            (res,), _ = served([doc], "numpy", SweepService, device=CPU)
            (ref,), _ = served([doc], "numpy")
            assert_identical(res.table, ref.table)
            assert res.meta["n_simulated"] == len(res.table["workload"])
        finally:
            del tpol.ALL_POLICIES["_simonly"], rpol.ALL_POLICIES["_simonly"]


class TestCoalescing:
    def test_numpy_equals_the_reference_service_and_direct_sweeps(self):
        ours, snap = served(COALESCE_SPECS, "numpy", SweepService, device=CPU)
        theirs, ref_snap = served(COALESCE_SPECS, "numpy")
        assert snap["kernel_calls"] == ref_snap["kernel_calls"] == 1
        assert snap["coalesce_factor"] == len(COALESCE_SPECS)
        for spec, a, b in zip(COALESCE_SPECS, ours, theirs):
            assert_identical(a.table, b.table)
            assert_identical(a.table, A.direct_table(spec, "numpy"))
            assert a.meta["qos"]["coalesced_queries"] == len(COALESCE_SPECS)
            for k in ("n_scenarios", "n_analytical", "n_timeline", "n_simulated"):
                assert a.meta[k] == b.meta[k], k

    def test_torch_coalesced_equals_direct_bit_for_bit_on_the_cpu(self):
        specs = COALESCE_SPECS + [{"grid": "frontier", "workloads": ["resnet50"],
                                   "workers": [8, 64], "seed": 7}]
        results, snap = served(specs, "torch", SweepService, device=CPU)
        assert snap["kernel_calls"] == 1
        for spec, res in zip(specs, results):
            assert res.meta["backend"] == "torch"
            assert_identical(res.table, A.direct_table(spec, "torch", CPU))
            A.assert_tables_agree(res.table, A.direct_table(spec, "numpy"), A.BATCHED_RTOL)

    def test_seeds_and_depths_split_groups(self):
        specs = [{"workloads": ["googlenet"], "workers": [8], "seed": 7},
                 {"workloads": ["alexnet"], "workers": [2, 4], "seed": 7},
                 {"workloads": ["googlenet"], "workers": [2],
                  "stragglers": ["lognormal:0.2x8"], "seed": 7},
                 {"workloads": ["googlenet"], "workers": [2], "seed": 1}]
        for backend in ("numpy", "torch"):
            results, snap = served(specs, backend, SweepService, device=CPU)
            assert snap["kernel_calls"] == 3      # googlenet seed 7, alexnet, seed 1
            for spec, res in zip(specs, results):
                assert_identical(res.table, A.direct_table(spec, backend, CPU))

    def test_concurrent_submitters(self):
        refs = [A.direct_table(s, "torch", CPU) for s in COALESCE_SPECS]
        out = [None] * len(COALESCE_SPECS)
        with SweepService(window_s=0.05, device=CPU) as svc:
            threads = [threading.Thread(
                target=lambda i, s: out.__setitem__(i, svc.query(dict(s), timeout=120)),
                args=(i, s)) for i, s in enumerate(COALESCE_SPECS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        for res, ref in zip(out, refs):
            assert_identical(res.table, ref)

    def test_a_failing_group_resolves_its_own_tickets(self, monkeypatch):
        def boom(*a, **kw):
            raise RuntimeError("device lost")

        monkeypatch.setattr("repro_torch.core.service.eval_scenarios_table_torch", boom)
        specs = COALESCE_SPECS[:2] + [{**COALESCE_SPECS[0], "backend": "numpy"}]
        with SweepService(window_s=0.5, device=CPU) as svc:
            tickets = [svc.submit(dict(s)) for s in specs]
            for t in tickets[:2]:
                with pytest.raises(QueryError, match="device lost") as ei:
                    t.wait(timeout=120)
                assert ei.value.code == "evaluation-failed"
            assert_identical(tickets[2].wait(timeout=120).table,
                             A.direct_table(specs[2], "numpy"))
            assert svc.stats_snapshot()["n_errors"] == 2


class TestAccounting:
    def test_cache_miss_then_hit(self, monkeypatch):
        monkeypatch.setattr(tworkloads, "_TABLES", {})
        monkeypatch.setattr(tbatched, "_EVALUATOR_MEMO", {})
        monkeypatch.setattr(BT, "_TORCH_MEMO", {})
        tables = []
        for backend, n in (("torch", 2), ("numpy", 3)):
            spec = {"workloads": ["alexnet"], "workers": [n], "backend": backend}
            with SweepService(window_s=0.0, device=CPU) as svc:
                first = svc.query(dict(spec), timeout=120)
                second = svc.query(dict(spec), timeout=120)
                snap = svc.stats_snapshot()
            assert first.meta["qos"]["cache"]["grid_structure"] == "miss"
            assert second.meta["qos"]["cache"]["grid_structure"] == "hit"
            assert snap["cache"]["grid_structure"] == {"hits": 1, "misses": 1,
                                                       "hit_rate": 0.5}
            tables.append(first.meta["qos"]["cache"]["workload_tables"])
        assert tables == ["miss", "hit"]

    def test_trailer_meta_matches_to_json_keys(self):
        spec = {"workloads": ["resnet50"], "workers": [4], "seed": 7}
        for backend in ("torch", "numpy"):
            with SweepService(window_s=0.0, device=CPU) as svc:
                res = svc.query({**spec, "backend": backend}, timeout=120)
            assert set(res.meta) == set(RESULT_META_KEYS) | {"qos"}
            grid = A.query_grid(spec)
            from repro_torch.core.sweep import sweep

            doc = json.loads(sweep(grid, backend=backend, seed=7,
                                   device=CPU if backend == "torch" else None).to_json())
            assert set(doc) - {"columns", "rows"} == set(RESULT_META_KEYS)
            for k in ("n_scenarios", "n_analytical", "n_timeline", "n_simulated", "backend"):
                assert res.meta[k] == doc[k], k

    def test_stats_and_closing(self):
        with SweepService(window_s=0.0, device=CPU) as svc:
            svc.query({"workloads": ["resnet50"], "workers": [4]}, timeout=120)
            snap = svc.stats_snapshot()
            with pytest.raises(QueryError) as ei:
                svc.submit({"workloads": []})
            assert ei.value.code == "bad-query"
        assert set(snap) == set(rservice.ServiceStats().snapshot())
        assert snap["n_queries"] == 1 and snap["kernel_calls"] == 1
        assert snap["sustained_scenarios_per_sec"] > 0 and snap["queue_depth"] == 0
        with pytest.raises(RuntimeError, match="closed"):
            svc.submit({"workloads": ["resnet50"], "workers": [4]})

    def test_cuda_unless_cpu_and_no_fallback(self, monkeypatch, capsys):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SweepService()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_sweep.make_server(port=0)
        assert serve_sweep.main(["--port", "0", "--no-warm"]) == 2
        assert "no CUDA device" in capsys.readouterr().err
        with SweepService(device=CPU) as svc:
            assert svc.device == torch.device("cpu")


@pytest.fixture(scope="class")
def server():
    srv = serve_sweep.make_server(port=0, window_s=0.02, device=CPU)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    srv.service.close()


@pytest.fixture(scope="class")
def ref_server():
    srv = rserve.make_server(port=0, window_s=0.02)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    srv.service.close()


class TestHTTPServer:
    def test_round_trip_equals_the_reference_server(self, server, ref_server):
        for fmt in ("columns", "rows"):
            spec = {"workloads": ["resnet50"], "workers": [4, 8], "seed": 7,
                    "stragglers": ["none", "lognormal:0.2x8"], "format": fmt}
            ours = A.http_query(server, {**spec, "backend": "numpy"})
            theirs = A.http_query(ref_server, spec)
            assert ours[0] == theirs[0] == {"type": "header", "columns": list(COLUMNS),
                                            "format": fmt, "n_scenarios": 120,
                                            "backend": "numpy"}
            assert ours[1:-1] == theirs[1:-1]
            assert_identical(serve_sweep.table_from_wire(ours),
                             A.direct_table(spec, "numpy"))
            torch_lines = A.http_query(server, spec)
            assert torch_lines[0]["backend"] == "torch"
            assert_identical(serve_sweep.table_from_wire(torch_lines),
                             A.direct_table(spec, "torch", CPU))
        rows = [r for ln in ours if ln["type"] == "rows" for r in ln["rows"]]
        assert_identical(table_from_rows(rows), A.direct_table(spec, "numpy"))

    def test_trailer_keys_and_to_json_parity(self, server):
        lines = A.http_query(server, {"workloads": ["resnet50"], "workers": [4]})
        trailer = lines[-1]
        assert trailer["type"] == "trailer"
        assert set(trailer) == {"type", "qos"} | set(RESULT_META_KEYS)
        assert set(trailer["qos"]) == {"queue_wait_s", "latency_s",
                                       "coalesced_queries", "cache"}
        from repro_torch.core.sweep import sweep

        doc = json.loads(sweep(A.query_grid({"workloads": ["resnet50"], "workers": [4]}),
                               device=CPU).to_json())
        assert set(doc) - {"columns", "rows"} == set(trailer) - {"type", "qos"}
        assert trailer["n_scenarios"] == doc["n_scenarios"] == len(doc["rows"])

    @pytest.mark.parametrize("body,code", [
        (b"{not json", "bad-json"),
        (json.dumps({"workloads": []}).encode(), "bad-query"),
        (json.dumps({"grid": "nope"}).encode(), "bad-query"),
        (json.dumps({"backend": "jax"}).encode(), "bad-query"),
        (json.dumps({"format": "xml"}).encode(), "bad-query"),
    ])
    def test_malformed_gets_structured_400(self, server, body, code):
        req = urllib.request.Request(f"http://127.0.0.1:{server}/query",
                                     data=body, method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req)
        assert ei.value.code == 400
        doc = json.loads(ei.value.read())
        assert doc["type"] == "error" and doc["code"] == code
        assert "Traceback" not in doc["error"]

    def test_disconnect_mid_stream_keeps_serving(self, server):
        body = json.dumps({"grid": "frontier", "workloads": ["resnet50"],
                           "workers": [8], "seed": 7}).encode()
        sock = socket.create_connection(("127.0.0.1", server))
        sock.sendall(b"POST /query HTTP/1.0\r\nContent-Length: %d\r\n\r\n%s"
                     % (len(body), body))
        sock.recv(512)
        sock.close()
        spec = {"workloads": ["resnet50"], "workers": [4], "seed": 7}
        assert_identical(serve_sweep.table_from_wire(A.http_query(server, spec)),
                         A.direct_table(spec, "torch", CPU))
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{server}/nope")
        assert ei.value.code == 404

    def test_stats_and_healthz(self, server, ref_server):
        assert A.http_get(server, "/healthz") == {"ok": True}
        stats = A.http_get(server, "/stats")
        assert set(stats) == set(A.http_get(ref_server, "/stats"))
        assert stats["n_queries"] > 0 and stats["kernel_calls"] > 0
