"""The port's sweep backend (``repro_torch.core.batched_torch``, float64
torch, here on the CPU) against the reference NumPy engine
(``repro.core.sweep(backend="numpy")`` / ``repro.core.batched``), case for
case with the reference's own ``tests/test_batched_jax.py`` (its mesh test
aside: one card has nothing to shard).  The reference's JAX backend does
not import on the installed jax, so the NumPy engine is the oracle, at the
reference suite's tolerance: <= 1e-6 relative, 1e-12 absolute, labels
exact.  Gradients are held to central differences on the port's NumPy twin
(``numpy_iteration_times``), rtol 1e-3."""
import dataclasses
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from strategies import scenario_grids

from repro.core import batched as rbatched
from repro.core import scenarios as rscen
from repro.core import sweep as rsweep
from repro_torch.core import batched_torch as BT
from repro_torch.core import policies as P
from repro_torch.core.batched import grid_evaluator
from repro_torch.core.hardware import CLUSTERS
from repro_torch.core.policies import Policy
from repro_torch.core.resulttable import COLUMNS
from repro_torch.core.scenarios import (Scenario, ScenarioGrid, default_grid,
                                        frontier_grid, mixed_grid)
from repro_torch.core.sweep import BACKENDS, sweep
from repro_torch.core.workloads import resolve_workload

CPU = "cpu"
NUMERIC = ("iteration_time_s", "samples_per_sec", "speedup", "t_comm_s",
           "t_comp_s", "t_mean_s", "t_p95_s", "t_p99_s")
LABELS = ("workload", "cluster", "n_workers", "policy", "collective",
          "interconnect", "het", "straggler", "sync_k", "faults",
          "batch_per_gpu", "method")
TIMELINE_POLICIES = ("bucketed-1mb", "bucketed-4mb", "bucketed-25mb",
                     "bucketed-100mb", "priority")
REL, ABS = 1e-6, 1e-12


def ref_grid(grid: ScenarioGrid) -> rscen.ScenarioGrid:
    return rscen.ScenarioGrid(**{f.name: getattr(grid, f.name)
                                 for f in dataclasses.fields(grid)})


def port_grid(grid: rscen.ScenarioGrid) -> ScenarioGrid:
    return ScenarioGrid(**{f.name: getattr(grid, f.name)
                           for f in dataclasses.fields(grid)})


def ref_scenario(s: Scenario) -> rscen.Scenario:
    return rscen.Scenario(**{f.name: getattr(s, f.name)
                             for f in dataclasses.fields(s)})


def assert_tables_agree(got: dict, want: dict, rel=REL):
    """Labels exact, every numeric column within ``rel`` (and 1e-12 abs)."""
    assert set(got) == set(want) == set(COLUMNS)
    assert len(got["workload"]) == len(want["workload"]) > 0
    for key in LABELS:
        assert got[key].tolist() == want[key].tolist(), key
    for key in NUMERIC:
        np.testing.assert_allclose(got[key], want[key], rtol=rel, atol=ABS,
                                   err_msg=key)


def assert_grid_agrees(grid: ScenarioGrid, seed=0):
    rt = sweep(grid, backend="torch", device=CPU, seed=seed)
    rn = rsweep.sweep(ref_grid(grid), backend="numpy", seed=seed)
    assert rt.backend == "torch" and rt.n_simulated == 0 == rn.n_simulated
    assert rt.n_analytical == rn.n_analytical
    assert rt.n_timeline == rn.n_timeline
    assert_tables_agree(rt.columns, rn.columns)
    return rt


class TestBuiltinGridAgreement:
    def test_default_grid(self):
        assert len(assert_grid_agrees(default_grid())) == 540

    def test_mixed_grid_spans_all_providers(self):
        g = mixed_grid()
        assert any(w.startswith("trace:") for w in g.workloads)
        assert any(w.startswith("llm:") for w in g.workloads)
        assert len(assert_grid_agrees(g)) == 1620

    def test_frontier_grid(self):
        r = assert_grid_agrees(frontier_grid())
        assert len(r) == 51840 and r.n_timeline == 25920

    def test_default_grid_bucketed_priority(self):
        assert_grid_agrees(dataclasses.replace(
            default_grid(), policies=TIMELINE_POLICIES))

    def test_eval_scenarios_table_torch_matches_numpy(self):
        scenarios = [
            Scenario("resnet50", "v100-nvlink-ib", 16, "caffe-mpi",
                     collective=c, interconnect=ic)
            for c in ("ring", "tree", "hierarchical")
            for ic in (None, "ib-100g@bw2@lat0.25")
        ] + [
            Scenario("trace:alexnet-k80", "k80-pcie-10gbe", 8, p)
            for p in ("naive", "bucketed-25mb", "priority")
        ] + [
            Scenario("llm:gemma3-1b", "tpu-v5e-pod", 4, "tensorflow",
                     batch_per_gpu=8),
        ]
        got = BT.eval_scenarios_table_torch(scenarios, device=CPU)
        want = rbatched.eval_scenarios_table([ref_scenario(s) for s in scenarios])
        assert_tables_agree(got, want)
        listed = sweep(scenarios, device=CPU)
        assert_tables_agree(listed.columns, want)
        assert (listed.n_analytical, listed.n_timeline) == (len(scenarios) - 2, 2)


class TestRandomGridProperty:
    @settings(max_examples=10, deadline=None)
    @given(scenario_grids(with_het=True, with_failures=True))
    def test_numpy_equals_torch_on_random_grids(self, grid):
        assert_grid_agrees(port_grid(grid), seed=3)


class TestMonteCarloTails:
    def test_stragglers_and_faults_draw_for_draw(self):
        """The tails come from the shared host pass: the same seeded draws
        as the reference's, per row."""
        grid = ScenarioGrid(
            workloads=("resnet50", "trace:alexnet-k80"),
            clusters=("v100-nvlink-ib",), worker_counts=(4, 16),
            policies=("caffe-mpi", "bucketed-25mb"),
            het_profiles=(None, "het:1x0.5+3x1.0"),
            stragglers=(None, "lognormal:0.25x64", "exp:0.5x32"),
            sync_ks=(None, 3),
            faults=(None, "fail:0.1@restart1.5x32"))
        r7 = assert_grid_agrees(grid, seed=7)
        r8 = sweep(grid, device=CPU, seed=8)
        live = np.array([s != "none" for s in r7.columns["straggler"]])
        assert live.any()
        # a different seed draws differently; deterministic rows do not move
        assert not np.array_equal(r7.columns["t_p99_s"][live],
                                  r8.columns["t_p99_s"][live])
        det = ~live & (r7.columns["faults"] == "none")
        np.testing.assert_array_equal(r7.columns["t_p99_s"][det],
                                      r7.columns["iteration_time_s"][det])


class TestDegenerateScenarios:
    def test_single_worker_zero_comm(self):
        grid = ScenarioGrid(workloads=("alexnet",),
                            clusters=("k80-pcie-10gbe",), worker_counts=(1,),
                            policies=TIMELINE_POLICIES + ("caffe-mpi",))
        r = sweep(grid, device=CPU)
        for row in r.rows:
            assert row["t_comm_s"] == 0.0
            assert row["speedup"] == pytest.approx(1.0)
        times = {row["policy"]: row["iteration_time_s"] for row in r.rows}
        for name in TIMELINE_POLICIES:
            assert times[name] == pytest.approx(times["caffe-mpi"], rel=1e-12)

    def test_zero_comm_workload_residuals_are_exactly_zero(self):
        """n <= 1: every collective coefficient is 0, so the WFBP and
        timeline residuals (max with 0 over the masked candidates) are
        exactly 0 — on the torch namespace's max as on NumPy's."""
        tev = BT.TorchGridEvaluator(ScenarioGrid(
            workloads=("googlenet",), clusters=("v100-nvlink-ib",),
            worker_counts=(1,), policies=("mxnet", "bucketed-25mb")),
            device=CPU)
        cols = tev.device_columns()
        assert torch.equal(cols["t_comm_s"], torch.zeros_like(cols["t_comm_s"]))
        kc = BT._kernel_cols_torch(tev._tables, tev._kcodes, tev._ucodes,
                                   tev._tl_overlaps, tev._coll_codes)
        for name in ("tc_no", "tl0"):
            assert torch.equal(kc[name], torch.zeros_like(kc[name])), name

    def test_one_giant_bucket_equals_fused_comm_at_end(self):
        s = Scenario("googlenet", "v100-nvlink-ib", 16, "bucketed-100mb")
        tab = resolve_workload(s.workload)
        assert float(tab.grad_bytes.sum()) < 100e6
        cluster = CLUSTERS[s.cluster]
        costs = tab.iteration_costs(cluster, tab.batch_default, 16)
        dur = cluster.allreduce_time(float(tab.grad_bytes.sum()), 16)
        want = max(costs.t_io + costs.t_h2d,
                   float(np.sum(costs.t_f) + np.sum(costs.t_b))
                   + dur + costs.t_u)
        table = BT.eval_scenarios_table_torch([s], device=CPU)
        assert table["method"].tolist() == ["timeline"]
        assert table["iteration_time_s"][0] == pytest.approx(want, rel=1e-9)

    def test_one_byte_buckets_equal_per_layer_wfbp(self):
        P.ALL_POLICIES["_bucket1b"] = Policy(
            "_bucket1b", overlap_io=True, h2d_early=True, overlap_comm=True,
            bucket_bytes=1.0)
        try:
            grid = ScenarioGrid(workloads=("alexnet", "resnet50"),
                                clusters=("v100-nvlink-ib",),
                                worker_counts=(4, 16),
                                policies=("_bucket1b", "caffe-mpi"))
            r = sweep(grid, device=CPU)
            b1 = r.filter(policy="_bucket1b")
            cm = r.filter(policy="caffe-mpi")
            assert len(b1) == len(cm) > 0
            for a, b in zip(b1, cm):
                assert a["method"] == "timeline" and b["method"] == "analytical"
                assert a["iteration_time_s"] == pytest.approx(
                    b["iteration_time_s"], rel=1e-9)
        finally:
            del P.ALL_POLICIES["_bucket1b"]


class TestGradientCorrectness:
    """torch.autograd through both tiers vs central finite differences on
    the NumPy twin (which rebuilds bucket partitions per call)."""

    @staticmethod
    def _fd_grad(grid, p0, key, rel_eps=1e-5):
        g = np.zeros_like(p0[key])
        for i in range(g.size):
            eps = abs(float(p0[key].ravel()[i])) * rel_eps or 1e-9
            hi = {k: v.copy() for k, v in p0.items()}
            lo = {k: v.copy() for k, v in p0.items()}
            hi[key].ravel()[i] += eps
            lo[key].ravel()[i] -= eps
            g.ravel()[i] = (BT.numpy_iteration_times(grid, hi).sum()
                            - BT.numpy_iteration_times(grid, lo).sum()) \
                / (2 * eps)
        return g

    def _check_family(self, policies):
        grid = ScenarioGrid(workloads=("resnet50",),
                            clusters=("v100-nvlink-ib",), worker_counts=(16,),
                            policies=policies,
                            collectives=("ring", "hierarchical"))
        p0 = BT.default_params(grid, device=CPU)
        got = BT.grad_iteration_time(grid, device=CPU)
        for k, v in got.items():
            assert v.shape == p0[k].shape and np.isfinite(v).all(), k
        np.testing.assert_allclose(
            BT.torch_grid_evaluator(grid, device=CPU).columns()["iteration_time_s"],
            BT.numpy_iteration_times(grid), rtol=1e-9)
        for key in ("intra_bw", "intra_lat", "inter_bw", "inter_lat"):
            want = self._fd_grad(grid, p0, key)
            np.testing.assert_allclose(got[key], want, rtol=1e-3,
                                       atol=1e-12, err_msg=key)
        assert any(np.abs(got[k]).max() > 0 for k in ("intra_bw", "inter_bw"))
        return grid, p0, got

    def test_closed_form_family(self):
        self._check_family(("caffe-mpi", "mxnet", "naive"))

    def test_timeline_family_and_flat_bucket_axis(self):
        grid, p0, got = self._check_family(
            ("bucketed-4mb", "bucketed-25mb", "priority"))
        assert p0["bucket_bytes"].size > 0
        want = self._fd_grad(grid, p0, "bucket_bytes")
        np.testing.assert_allclose(got["bucket_bytes"], 0.0, atol=1e-12)
        np.testing.assert_allclose(want, 0.0, atol=1e-12)

    def test_gradients_finite_over_every_collective_and_het(self):
        """Every algorithm is evaluated on every point and selected by
        ``where``: the unselected branches' gradients must stay finite (the
        safe_n / safe_g forms), here with n = 1 points, tree and
        heterogeneous links in the grid."""
        grid = ScenarioGrid(workloads=("alexnet", "trace:alexnet-k80"),
                            clusters=("k80-pcie-10gbe", "v100-nvlink-ib"),
                            worker_counts=(1, 2, 7, 32),
                            policies=("naive", "mxnet", "bucketed-25mb"),
                            collectives=("ring", "tree", "hierarchical"),
                            het_profiles=(None, "het:2x1.0@bw0.5@lat2"))
        got = BT.grad_iteration_time(grid, device=CPU)
        for k, v in got.items():
            assert np.isfinite(v).all(), k
        assert all(np.abs(got[k]).max() > 0 for k in
                   ("intra_bw", "intra_lat", "inter_bw", "inter_lat"))

    def test_unknown_param_key_rejected(self):
        f, p0 = BT.iteration_time_fn(default_grid(), device=CPU)
        with pytest.raises(ValueError, match="unknown param keys"):
            f({**p0, "warp_drive": np.ones(3)})

    def test_param_tensor_must_be_float64_on_the_device(self):
        f, p0 = BT.iteration_time_fn(default_grid(), device=CPU)
        with pytest.raises(ValueError, match="float64"):
            f({"intra_bw": torch.tensor(p0["intra_bw"], dtype=torch.float32)})


class TestBackendRouting:
    def test_unknown_backend(self):
        for grid in (default_grid(), default_grid().expand()[:3]):
            with pytest.raises(ValueError, match="unknown backend"):
                sweep(grid, backend="jax")
        assert BACKENDS == ("torch", "numpy")

    def test_numpy_backend_takes_no_device(self):
        with pytest.raises(ValueError, match="device"):
            sweep(default_grid(), backend="numpy", device=CPU)

    def test_cuda_is_the_default_and_never_falls_back(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sweep(default_grid())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BT.TorchGridEvaluator(default_grid())

    def test_rejects_simulator_only_policies(self):
        P.ALL_POLICIES["_simonly"] = Policy(
            "_simonly", overlap_io=False, overlap_comm=True,
            bucket_bytes=25e6)
        try:
            grid = ScenarioGrid(workloads=("alexnet",),
                                clusters=("v100-nvlink-ib",),
                                worker_counts=(2,),
                                policies=("caffe-mpi", "_simonly"))
            for backend, device in (("torch", CPU), ("numpy", None)):
                with pytest.raises(ValueError, match="_simonly"):
                    sweep(grid, backend=backend, device=device)
            with pytest.raises(ValueError, match="_simonly"):
                BT.eval_scenarios_table_torch(grid.expand(), device=CPU)
            with pytest.raises(ValueError, match="_simonly"):
                BT.TorchGridEvaluator(grid, device=CPU)
        finally:
            del P.ALL_POLICIES["_simonly"]

    def test_sweep_result_json_carries_backend(self, tmp_path):
        r = sweep(ScenarioGrid(workloads=("alexnet",), worker_counts=(2,)),
                  device=CPU)
        path = tmp_path / "r.json"
        r.to_json(str(path))
        doc = json.loads(path.read_text())
        assert doc["backend"] == "torch" and doc["n_simulated"] == 0

    def test_numpy_backend_is_the_reference_bit_for_bit(self):
        grid = dataclasses.replace(default_grid(), policies=TIMELINE_POLICIES)
        got = sweep(grid, backend="numpy").columns
        want = rsweep.sweep(ref_grid(grid), backend="numpy").columns
        for k in COLUMNS:
            assert got[k].tolist() == want[k].tolist(), k


class TestKernelSurface:
    def test_columns_slice_matches_numpy_gridrun(self):
        grid = default_grid()
        tr = BT.torch_grid_evaluator(grid, device=CPU).run()
        nr = grid_evaluator(grid).run()
        a = tr.columns_slice(7, 203)
        b = nr.columns_slice(7, 203)
        for k in NUMERIC:
            np.testing.assert_allclose(a[k], b[k], rtol=REL, err_msg=k)
        assert a["method"] == ["analytical"] * (203 - 7)

    def test_device_columns_stay_on_the_device(self):
        tev = BT.torch_grid_evaluator(default_grid(), device=CPU)
        cols = tev.device_columns()
        assert all(v.device.type == "cpu" and v.dtype == torch.float64
                   for v in cols.values())
        assert all(t.device.type == "cpu" for t in tev._tables.values())

    def test_memo_and_cache_probe(self):
        grid = dataclasses.replace(default_grid(), worker_counts=(3, 5))
        tev = BT.torch_grid_evaluator(grid, device=CPU)
        assert BT.torch_grid_evaluator(grid, device=CPU) is tev
        assert BT.torch_grid_evaluator(
            dataclasses.replace(grid, worker_counts=(3, 7)), device=CPU) is not tev

    def test_empty_grid_columns(self):
        grid = dataclasses.replace(default_grid(), worker_counts=())
        cols = BT.TorchGridEvaluator(grid, device=CPU).columns()
        assert all(v.size == 0 for v in cols.values())


class TestCli:
    def test_default_grid_rows_equal_the_reference_cli(self, tmp_path, capsys):
        from repro.launch.sweep import main as ref_main
        from repro_torch.sweep import main

        assert main(["--device", "cpu", "--csv", str(tmp_path / "t.csv")]) == 0
        ours = capsys.readouterr().out.splitlines()
        assert ref_main(["--csv", str(tmp_path / "r.csv")]) == 0
        theirs = capsys.readouterr().out.splitlines()
        # the printed table equal row for row; only the timing line differs
        assert ours[0] == theirs[0] and ours[2:-1] == theirs[2:-1]
        assert "540 analytical, 0 timeline, 0 simulated" in ours[1]
        a = np.genfromtxt(tmp_path / "t.csv", delimiter=",", names=True,
                          dtype=None, encoding=None)
        b = np.genfromtxt(tmp_path / "r.csv", delimiter=",", names=True,
                          dtype=None, encoding=None)
        assert len(a) == len(b) == 540
        for name in a.dtype.names:
            if a.dtype[name].kind == "f":
                np.testing.assert_allclose(a[name], b[name], rtol=REL,
                                           atol=ABS, err_msg=name)
            else:
                assert a[name].tolist() == b[name].tolist(), name

    def test_errors_exit_2(self, capsys):
        from repro_torch.sweep import main

        assert main(["--device", "cpu", "--policies", "warp"]) == 2
        assert main(["--device", "cpu", "--sort", "warp"]) == 2
        assert main(["--backend", "numpy", "--device", "cpu"]) == 2
        assert "error:" in capsys.readouterr().err

    def test_no_gpu_is_an_error(self, monkeypatch, capsys):
        from repro_torch.sweep import main

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert main([]) == 2
        assert "no CUDA device" in capsys.readouterr().err
        assert main(["--backend", "numpy", "--top", "1"]) == 0
