"""The port's three example twins (``repro_torch.examples``) at
``--device cpu``, against the reference's programs.

* ``table6_trace`` against ``benchmarks/bench_table6_trace.py``: the same
  bundled totals and round trip; the fresh AlexNet trace (99 x 99 here,
  where the reference bench's 64 x 64 leaves pool5 empty) has the
  reference's layers, gradient bytes and K80 comm column, and resolves
  through ``trace:<file>``.
* ``trace_analysis`` against ``examples/trace_analysis.py``: the bundled
  study prints the same text; the live ``torch:`` workload predicts beside
  ``trace:alexnet-k80`` as the reference predicts that trace.
* ``dag_validation`` against ``examples/dag_validation.py``: the same
  ``RESULT`` keys, and the DAG predictions recomputed by the reference's
  model from the port's measured costs are ``==`` to the port's.
"""
import ast
import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import jax
import pytest

from repro.core import analytical as janalytical
from repro.core import dag as jdag
from repro.core import hardware as jhardware
from repro.core import policies as jpolicies
from repro.core import predictor as jpredictor
from repro.core import simulator as jsim
from repro.core.hardware import K80_CLUSTER
from repro.models import cnn as jcnn
from repro.traces import bundled as jbundled
from repro.traces import format as jformat
from repro.traces import generate as jgenerate
from repro_torch.examples import dag_validation, table6_trace, trace_analysis
from repro_torch.measure.run import SMOKE_GEOMETRY

ROOT = Path(__file__).resolve().parents[1]


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(f"_ref_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestTable6:
    @pytest.fixture(scope="class")
    def printed(self, tmp_path_factory):
        import contextlib
        import io

        out_dir = tmp_path_factory.mktemp("table6")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = table6_trace.main(["--device", "cpu", "--out-dir", str(out_dir)])
        assert rc == 0
        return json.loads(buf.getvalue().strip().splitlines()[-1]), out_dir

    def test_bundled_numbers_equal_the_reference_bench(self, printed):
        from benchmarks import bench_table6_trace

        doc, _ = printed
        ref = bench_table6_trace.run()
        assert doc["grad_bytes"] == ref["grad_bytes"] == jbundled.TOTAL_GRAD_BYTES
        assert doc["roundtrip_ok"] is ref["roundtrip_ok"] is True
        costs = jbundled.ALEXNET_K80.to_iteration_costs()
        assert doc["totals"] == {"grad_MB": jbundled.TOTAL_GRAD_BYTES / 1e6,
                                 "t_io_s": costs.t_io, "fwd_s": sum(costs.t_f),
                                 "bwd_s": sum(costs.t_b), "comm_s": sum(costs.t_c)}
        assert doc["device"] == "cpu"

    def test_fresh_alexnet_trace_has_the_reference_layers(self, printed):
        _, out_dir = printed
        path = out_dir / "alexnet.trace"
        back = jformat.read_trace(path)
        jlayers, _ = jcnn.alexnet_timed_layers(jax.random.PRNGKey(0), input_hw=99)
        recs = back.mean_iteration()
        assert [r.name for r in recs] == [l.name for l in jlayers]
        sizes = [jgenerate._param_bytes(l.params) for l in jlayers]
        assert [r.size_bytes for r in recs] == sizes
        assert [r.comm_us for r in recs] == \
            [K80_CLUSTER.allreduce_time(b, 16) * 1e6 if b else 0.0 for b in sizes]
        assert all(r.forward_us > 0 for r in recs)
        assert [r.backward_us > 0 for r in recs] == [s > 0 for s in sizes]
        assert back.batch_per_gpu == 2 and back.cluster == "torch-cpu-f32"
        p = jpredictor.predict_workload(f"trace:{path}", jhardware.CLUSTERS["v100-nvlink-ib"],
                                        8, jpolicies.CAFFE_MPI)
        assert math.isfinite(p.iteration_time) and p.iteration_time > 0

    def test_fresh_resnet_trace_resolves(self, printed):
        _, out_dir = printed
        back = jformat.read_trace(out_dir / "resnet50.trace")
        assert [r.name for r in back.mean_iteration()] == \
            ["conv1", "pool1", "res2a", "res3a", "res4a", "res5a", "fc"]


def _reference_trace_analysis():
    mod = _load(ROOT / "examples" / "trace_analysis.py")
    mod.measured_jax_workload = lambda: None
    return mod


def test_bundled_study_prints_the_reference_text(capsys):
    _reference_trace_analysis().main()
    want = capsys.readouterr().out
    trace_analysis.bundled_study()
    assert capsys.readouterr().out == want


def test_live_torch_workload_predicts_beside_table6():
    out = trace_analysis.measured_torch_workload("cpu")
    layers, live = out["torch:qwen-tiny"]
    assert layers == 3                      # embed_head + 2 units
    assert math.isfinite(live.iteration_time) and live.iteration_time > 0
    n, table6 = out["trace:alexnet-k80"]
    ref = jpredictor.predict_workload("trace:alexnet-k80", jhardware.CLUSTERS["v100-nvlink-ib"],
                                      8, jpolicies.CAFFE_MPI)
    assert n == 22 and dataclasses.asdict(table6) == dataclasses.asdict(ref)


def _reference_result_keys() -> list:
    tree = ast.parse((ROOT / "examples" / "dag_validation.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and \
                [t.id for t in node.targets if isinstance(t, ast.Name)] == ["out"]:
            return [k.value for k in node.value.keys]
    raise AssertionError("no RESULT dict in examples/dag_validation.py")


class TestDagValidation:
    @pytest.fixture(scope="class")
    def doc(self):
        geometry = dataclasses.replace(SMOKE_GEOMETRY, n_devices=2)
        return dag_validation.run_validation(geometry, steps=2, device="cpu")

    def test_result_keys_equal_the_reference(self, doc):
        keys = _reference_result_keys()
        assert "prediction_error_pct" in keys
        assert list(doc["result"]) == keys
        for k, v in doc["result"].items():
            if not isinstance(v, str):
                assert math.isfinite(v) and v > 0, k

    def test_layers_and_launches(self, doc):
        assert [r["name"] for r in doc["layers"]] == \
            ["embed"] + [f"layer{u}" for u in range(SMOKE_GEOMETRY.num_layers)] + \
            ["head", "loss"]
        assert doc["layers"][-1]["size_bytes"] == 4.0          # the loss's dummy parameter
        assert all(r["forward_us"] > 0 and r["backward_us"] > 0 for r in doc["layers"])
        assert doc["device"] == "cpu" and not any(doc["kernel_launches"].values())

    def test_predictions_equal_the_reference_model(self, doc):
        """The reference's DAG model on the port's measured costs gives the
        port's predictions, with and without ``shared_compute``."""
        layers = doc["layers"]
        costs = jdag.IterationCosts(
            t_f=[r["forward_us"] * 1e-6 for r in layers],
            t_b=[r["backward_us"] * 1e-6 for r in layers],
            t_c=[r["comm_s"] for r in layers], t_io=0.0, t_h2d=0.0, t_u=doc["t_update_s"])
        res = doc["result"]

        def steady(pol, shared):
            g = jdag.build_ssgd_dag(costs, 2, pol, n_iterations=5, shared_compute=shared)
            return jsim.simulate(g).steady_iteration_time()

        assert res["predicted_wfbp_s"] == steady(jpolicies.CAFFE_MPI, True)
        assert res["predicted_cntk_s"] == steady(jpolicies.CNTK, True)
        assert res["predicted_wfbp_ideal_parallel_s"] == steady(jpolicies.CAFFE_MPI, False)
        assert res["eq5_ideal_s"] == janalytical.eq5_wfbp(costs)
        assert res["predicted_wfbp_s"] >= res["predicted_wfbp_ideal_parallel_s"]
        err = abs(res["predicted_wfbp_s"] - res["measured_wfbp_s"]) / \
            res["measured_wfbp_s"] * 100
        assert res["prediction_error_pct"] == err

    def test_main_prints_result(self, doc, monkeypatch, capsys):
        monkeypatch.setattr(dag_validation, "run_validation", lambda *a: doc)
        assert dag_validation.main(["--device", "cpu", "--smoke", "--steps", "2"]) == 0
        out = capsys.readouterr().out
        assert json.loads(out[out.index("RESULT ") + 7:]) == doc["result"]

