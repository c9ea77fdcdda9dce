"""The port's per-scenario and event-driven simulator paths, chunked
streaming and the worker pool (``repro_torch.core.{resulttable,scenarios,
dag,simulator,batched,sweep,parallel,workloads}``), held against the
reference's NumPy modules on the same inputs: every copied function ``==``
the reference's, every streamed, chunked or pooled table bit for bit, and
the batched rows (NumPy, and torch on the CPU) within 1e-6 relative of the
event-driven simulator on every built-in policy with het, straggler,
``sync_k`` and fault axes — the reference suite's oracle bound.  Oracle
grids stay small (few workers, draws of x8), since the simulator runs the
whole DAG once per draw."""
import dataclasses
import json
import os
import signal

import numpy as np
import pytest

from repro.core import batched as rbatched
from repro.core import dag as rdag
from repro.core import parallel as rparallel
from repro.core import policies as rpolicies
from repro.core import resulttable as rrt
from repro.core import scenarios as rscen
from repro.core import simulator as rsim
from repro.core import sweep as rsweep
from repro.core import workloads as rworkloads
from repro_torch.core import agreement as A
from repro_torch.core import batched as tbatched
from repro_torch.core import batched_torch as BT
from repro_torch.core import dag as tdag
from repro_torch.core import parallel as tparallel
from repro_torch.core import policies as tpolicies
from repro_torch.core import resulttable as trt
from repro_torch.core import scenarios as tscen
from repro_torch.core import simulator as tsim
from repro_torch.core import sweep as tsweep
from repro_torch.core import workloads as tworkloads
from repro_torch.core.costmodel import comm_scale_fn
from repro_torch.core.scenarios import Scenario, ScenarioGrid

CPU = "cpu"
COLUMNS = trt.COLUMNS
ORACLE_COLS = ("iteration_time_s", "t_mean_s", "t_p95_s", "t_p99_s",
               "samples_per_sec", "speedup")
HET = "het:1x0.5+3x1.0"
STRAGGLER = "lognormal:0.25x8"
FAULT = "fail:0.2@restart1.5x8"


def ref_grid(grid: ScenarioGrid) -> rscen.ScenarioGrid:
    return rscen.ScenarioGrid(**{f.name: getattr(grid, f.name)
                                 for f in dataclasses.fields(grid)})


def ref_scenario(s: Scenario) -> rscen.Scenario:
    return rscen.Scenario(**{f.name: getattr(s, f.name)
                             for f in dataclasses.fields(s)})


def assert_identical(got: dict, want: dict):
    assert set(got) == set(want) == set(COLUMNS)
    for k in COLUMNS:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def small_grid(**kw) -> ScenarioGrid:
    base = dict(workloads=("alexnet", "trace:alexnet-k80"),
                clusters=("v100-nvlink-ib",), worker_counts=(2, 4),
                policies=("caffe-mpi", "cntk", "bucketed-25mb", "priority"),
                collectives=("ring", "hierarchical"))
    base.update(kw)
    return ScenarioGrid(**base)


def failure_grid() -> ScenarioGrid:
    """Every axis of the failure and het engines at two values; 96
    scenarios, a third of them stochastic (x8)."""
    return ScenarioGrid(workloads=("alexnet",), clusters=("v100-nvlink-ib",),
                        worker_counts=(2, 4),
                        policies=("tensorflow", "caffe-mpi", "bucketed-25mb"),
                        collectives=("ring",), het_profiles=(None, HET),
                        stragglers=(None, STRAGGLER), sync_ks=(None, 3),
                        faults=(None, FAULT))


SCENARIOS = [
    Scenario("alexnet", "v100-nvlink-ib", 4, "caffe-mpi"),
    Scenario("resnet50", "k80-pcie-10gbe", 2, "cntk", collective="tree"),
    Scenario("trace:alexnet-k80", "v100-nvlink-ib", 4, "bucketed-4mb"),
    Scenario("alexnet", "v100-nvlink-ib", 4, "priority", het=HET),
    Scenario("alexnet", "v100-nvlink-ib", 4, "tensorflow", het=HET,
             straggler=STRAGGLER),
    Scenario("alexnet", "v100-nvlink-ib", 8, "mxnet", het="het:1x0.5+7x1.0",
             sync_k=6, faults="fail:0.3@restart2x8"),
    Scenario("googlenet", "v100-nvlink-ib", 4, "naive",
             interconnect="ib-100g@bw2@lat0.25", faults=FAULT),
]


@pytest.fixture
def simonly():
    """A policy with neither batched form, registered in both packages."""
    pol = dict(name="_simonly", overlap_io=False, overlap_comm=True,
               bucket_bytes=25e6)
    tpolicies.ALL_POLICIES["_simonly"] = tpolicies.Policy(**pol)
    rpolicies.ALL_POLICIES["_simonly"] = rpolicies.Policy(**pol)
    yield "_simonly"
    del tpolicies.ALL_POLICIES["_simonly"], rpolicies.ALL_POLICIES["_simonly"]


class TestResultTableCopies:
    def test_helpers_equal_reference(self):
        rows = rsweep.sweep(ref_grid(failure_grid()), seed=3).rows
        table = trt.table_from_rows(rows)
        assert_identical(table, rrt.table_from_rows(rows))
        assert_identical(trt.table_from_rows([]), rrt.table_from_rows([]))
        parts = [trt.slice_table(table, lo, lo + 7) for lo in range(0, len(rows), 7)]
        assert all(np.shares_memory(p["iteration_time_s"], table["iteration_time_s"])
                   for p in parts)                            # views, not copies
        assert_identical(trt.concat_tables(parts),
                         rrt.concat_tables([rrt.slice_table(table, lo, lo + 7)
                                            for lo in range(0, len(rows), 7)]))
        assert trt.concat_tables([parts[0]]) is parts[0]
        assert_identical(trt.concat_tables([]), rrt.empty_table())
        ours, theirs = ({k: v.copy() for k, v in table.items()} for _ in range(2))
        idx, new = [1, 5, 9], [rows[0], rows[2], rows[4]]
        trt.fill_rows(ours, idx, new)
        rrt.fill_rows(theirs, idx, new)
        assert_identical(ours, theirs)
        assert trt.FLOAT_COLUMNS == rrt.FLOAT_COLUMNS


class TestScenarioCopies:
    def grid(self):
        return ScenarioGrid(workloads=("alexnet", "llm:qwen1.5-4b"),
                            clusters=("k80-pcie-10gbe", "v100-nvlink-ib"),
                            worker_counts=(1, 3, 16), policies=("cntk", "priority"),
                            interconnects=(None, "ib-100g@bw2@lat0.25"),
                            het_profiles=(None, HET, "het:2x1.0@bw0.5",
                                          "het:1x0.7@lat2.0+1x1.3"),
                            stragglers=(None, STRAGGLER), sync_ks=(None, 2),
                            faults=(None, FAULT))

    def test_scenario_at_equals_expand_and_reference(self):
        grid = self.grid()
        rg = ref_grid(grid)
        expanded = grid.expand()
        for i in range(len(grid)):
            s = grid.scenario_at(i)
            assert s == expanded[i]
            assert dataclasses.asdict(s) == dataclasses.asdict(rg.scenario_at(i))

    def test_resolve_cluster_and_policy_equal_reference(self):
        seen = set()
        for s in self.grid().expand():
            key = (s.cluster, s.n_workers, s.interconnect, s.het, s.policy)
            if key in seen:
                continue
            seen.add(key)
            r = ref_scenario(s)
            assert dataclasses.asdict(tscen.resolve_cluster(s)) == \
                dataclasses.asdict(rscen.resolve_cluster(r)), key
            assert dataclasses.asdict(tscen.resolve_policy(s)) == \
                dataclasses.asdict(rscen.resolve_policy(r))
        assert len(seen) == 2 * 3 * 2 * 4 * 2

    def test_apply_het_links(self):
        from repro.core.hardware import CLUSTERS as RCLUSTERS
        from repro_torch.core.hardware import CLUSTERS

        for name in CLUSTERS:
            c = CLUSTERS[name]
            assert tscen.apply_het_links(c, 1.0, 1.0) is c
            assert dataclasses.asdict(tscen.apply_het_links(c, 0.5, 2.0)) == \
                dataclasses.asdict(rscen.apply_het_links(RCLUSTERS[name], 0.5, 2.0))


def _costs(mod, L=5, seed=0):
    rng = np.random.default_rng(seed)
    t_c = rng.uniform(0, 2e-3, L)
    t_c[1] = 0.0                                       # a layer without params
    return mod.IterationCosts(t_f=rng.uniform(1e-4, 3e-3, L).tolist(),
                              t_b=rng.uniform(1e-4, 5e-3, L).tolist(),
                              t_c=t_c.tolist(), t_io=2e-3, t_h2d=1e-3, t_u=5e-4,
                              grad_bytes=(t_c * 1e9).tolist())


#: (worker_scale, sync_k, crashed, restart_s) of the builder's het and
#: failure axes, over 4 workers.
AXES = [(None, None, (), 0.0),
        ([1.0, 2.0, 1.0, 1.5], None, (), 0.0),
        ([1.3, 1.0, 2.0, 1.0], 2, (), 0.0),
        (None, 3, (1, 3), 0.5),
        ([1.0, 1.0, 1.0, 4.0], 3, (3,), 0.25),
        (None, 9, (0,), 0.0)]


def _dag_view(dag):
    return ([(t.tid, t.name, t.kind.value, t.duration, t.channel, t.iteration,
              t.layer, t.worker, t.priority, t.nbytes) for t in dag.tasks.values()],
            {t: sorted(p) for t, p in dag.preds.items()},
            {t: sorted(s) for t, s in dag.succs.items()})


class TestDagAndSimulatorAxes:
    @pytest.mark.parametrize("policy", ["naive", "cntk", "caffe-mpi",
                                        "bucketed-4mb", "priority"])
    @pytest.mark.parametrize("axes", AXES, ids=range(len(AXES)))
    def test_builder_and_steady_state_equal_reference(self, policy, axes):
        ws, sk, crashed, restart = axes
        kw = dict(worker_scale=ws, sync_k=sk, crashed=crashed, restart_s=restart)
        tp, rp = tpolicies.get_policy(policy), rpolicies.get_policy(policy)
        tc, rc = _costs(tdag), _costs(rdag)
        from repro.core.costmodel import comm_scale_fn as rcomm
        from repro.core.hardware import CLUSTERS as RCLUSTERS
        from repro_torch.core.hardware import CLUSTERS

        tcs = comm_scale_fn(CLUSTERS["v100-nvlink-ib"], 4, "ring") if tp.bucket_bytes else None
        rcs = rcomm(RCLUSTERS["v100-nvlink-ib"], 4, "ring") if rp.bucket_bytes else None
        t = tdag.build_ssgd_dag(tc, 4, tp, n_iterations=2, comm_scale=tcs, **kw)
        r = rdag.build_ssgd_dag(rc, 4, rp, n_iterations=2, comm_scale=rcs, **kw)
        assert _dag_view(t) == _dag_view(r)
        assert tsim.simulate_steady(tc, 4, tp, comm_scale=tcs, **kw) == \
            rsim.simulate_steady(rc, 4, rp, comm_scale=rcs, **kw)
        ts = tsim.simulate_policy(tc, 4, tp, n_iterations=3, comm_scale=tcs, **kw)
        rs = rsim.simulate_policy(rc, 4, rp, n_iterations=3, comm_scale=rcs, **kw)
        view = [(s.task.tid, s.task.channel, s.start, s.finish) for s in ts.timeline()]
        assert view == [(s.task.tid, s.task.channel, s.start, s.finish)
                        for s in rs.timeline()]
        for ch in ("gpu:0", "gpu:3", "net", "ckpt"):
            assert [(s.task.tid, s.start) for s in ts.tasks_on(ch)] == \
                [(s.task.tid, s.start) for s in rs.tasks_on(ch)]

    def test_builder_rejects_like_the_reference(self):
        pol = tpolicies.get_policy("caffe-mpi")
        for kw in (dict(worker_scale=[1.0, 1.0]), dict(worker_scale=[1.0, 0.0, 1.0]),
                   dict(restart_s=-1.0), dict(crashed=(3,))):
            with pytest.raises(ValueError):
                tdag.SSGDDagBuilder(_costs(tdag), 3, pol, **kw)
            with pytest.raises(ValueError):
                rdag.SSGDDagBuilder(_costs(rdag), 3, rpolicies.get_policy("caffe-mpi"), **kw)

    def test_with_comm_equals_reference(self):
        tc, rc = _costs(tdag), _costs(rdag)
        zeros = [0.0] * tc.num_layers
        assert dataclasses.asdict(tc.with_comm(zeros)) == \
            dataclasses.asdict(rc.with_comm(zeros))
        assert dataclasses.asdict(tc.with_comm(zeros, [1.0] * 5)) == \
            dataclasses.asdict(rc.with_comm(zeros, [1.0] * 5))


class TestPerScenarioPaths:
    @pytest.mark.parametrize("i", range(len(SCENARIOS)))
    def test_rows_equal_reference(self, i):
        s = SCENARIOS[i]
        r = ref_scenario(s)
        assert tsweep._sim_eval(s, seed=5) == rsweep._sim_eval(r, seed=5)
        assert tsweep.evaluate_scenario(s, seed=5) == rsweep.evaluate_scenario(r, seed=5)
        assert tsweep.evaluate_scenario(s, "simulator", warm_iterations=4, seed=1) == \
            rsweep.evaluate_scenario(r, "simulator", warm_iterations=4, seed=1)
        if tsweep.has_fast_path(tscen.resolve_policy(s)):
            assert tsweep._fast_eval(s, seed=5) == rsweep._fast_eval(r, seed=5)
            assert tsweep.evaluate_scenario(s, "analytical") == \
                rsweep.evaluate_scenario(r, "analytical")

    def test_path_predicates_and_errors_equal_reference(self):
        for name, pol in tpolicies.ALL_POLICIES.items():
            rp = rpolicies.get_policy(name)
            assert tsweep.has_fast_path(pol) == rsweep.has_fast_path(rp)
            assert tsweep.has_batched_path(pol) == rsweep.has_batched_path(rp)
        s = Scenario("alexnet", "v100-nvlink-ib", 4, "bucketed-25mb")
        for mod, scn in ((tsweep, s), (rsweep, ref_scenario(s))):
            with pytest.raises(ValueError, match="no exact closed form"):
                mod.evaluate_scenario(scn, "analytical")
            with pytest.raises(ValueError, match="unknown method"):
                mod.evaluate_scenario(scn, "warp")
        assert tsweep.RESULT_META_KEYS == rsweep.RESULT_META_KEYS
        assert tsweep.DEFAULT_CHUNK == rsweep.DEFAULT_CHUNK


class TestBatchedCopies:
    def test_eval_scenarios_equal_reference(self):
        scenarios = failure_grid().expand()[::5]
        assert tbatched.eval_scenarios(scenarios, seed=2) == \
            rbatched.eval_scenarios([ref_scenario(s) for s in scenarios], seed=2)
        assert tbatched.eval_scenarios([]) == []

    def test_run_span_scenario_at_rows_slice_equal_reference(self, simonly):
        grid = small_grid(policies=("caffe-mpi", simonly, "priority"),
                          stragglers=(None, STRAGGLER))
        ev, rev = tbatched.grid_evaluator(grid), rbatched.grid_evaluator(ref_grid(grid))
        assert not ev.all_batched
        for lo, hi in ((0, len(grid)), (3, 17), (len(grid) - 5, len(grid))):
            (t, m), (r, rm) = ev.run_span(lo, hi, seed=4), rev.run_span(lo, hi, seed=4)
            assert_identical(t, r)
            assert np.array_equal(m, rm) and not m.all()
            assert ev.run(seed=4).rows_slice(lo, hi) == rev.run(seed=4).rows_slice(lo, hi)
        assert dataclasses.asdict(ev.scenario_at(11)) == \
            dataclasses.asdict(rev.scenario_at(11))

    def test_structure_probes(self):
        grid = small_grid(worker_counts=(3, 5, 7))
        assert not tbatched.evaluator_cached(grid)
        assert not BT.torch_evaluator_cached(grid, CPU)
        assert not tbatched.evaluator_cached(grid)         # probing adds nothing
        tbatched.grid_evaluator(grid)
        assert tbatched.evaluator_cached(grid)
        assert not BT.torch_evaluator_cached(grid, CPU)
        BT.torch_grid_evaluator(grid, device=CPU)
        assert BT.torch_evaluator_cached(grid, CPU)
        assert not BT.torch_evaluator_cached(dataclasses.replace(grid, worker_counts=(9,)), CPU)

    def test_workload_cache_probe_and_clear(self, monkeypatch):
        monkeypatch.setattr(tworkloads, "_TABLES", {})
        monkeypatch.setattr(rworkloads, "_TABLES", {})
        for name in ("alexnet", "cnn:resnet50", "trace:alexnet-k80", "nope:x", "llm:nope"):
            assert tworkloads.workload_cached(name) is rworkloads.workload_cached(name) is False
        tworkloads.resolve_workload("alexnet")
        rworkloads.resolve_workload("alexnet")
        for name in ("alexnet", "cnn:alexnet", "resnet50"):
            assert tworkloads.workload_cached(name) == rworkloads.workload_cached(name)
        assert tworkloads.workload_cached("cnn:alexnet")
        tworkloads.clear_workload_cache()
        assert not tworkloads.workload_cached("alexnet")


class TestOracleAgreement:
    """The fast paths against the port's event-driven simulator, <= 1e-6
    relative (the reference's ``tests/test_sweep.py:89-143`` and its het
    and failure oracle tests)."""

    @pytest.mark.parametrize("policy", ["naive", "cntk", "mxnet", "caffe-mpi"])
    def test_closed_forms_match_the_simulator(self, policy):
        grid = ScenarioGrid(workloads=("alexnet", "googlenet"),
                            clusters=("v100-nvlink-ib",), worker_counts=(1, 2, 4),
                            policies=(policy,),
                            collectives=("ring", "tree", "hierarchical"))
        for s in grid.expand():
            fast = tsweep.evaluate_scenario(s, method="analytical")
            slow = tsweep.evaluate_scenario(s, method="simulator")
            assert fast["iteration_time_s"] == pytest.approx(
                slow["iteration_time_s"], rel=1e-6), s.label()

    def test_every_builtin_policy_on_every_path(self):
        grid = small_grid(policies=tuple(tpolicies.ALL_POLICIES))
        sim = tsweep.sweep(grid, backend="numpy", force_simulator=True)
        assert (sim.n_simulated, sim.n_analytical, sim.n_timeline) == (len(grid), 0, 0)
        assert_identical(sim.columns, rsweep.sweep(ref_grid(grid), force_simulator=True).columns)
        batched = tsweep.sweep(grid, backend="numpy")
        per = tsweep.sweep(grid, backend="numpy", batched=False)
        on_torch = tsweep.sweep(grid, device=CPU)
        assert batched.n_simulated == on_torch.n_simulated == 0 < batched.n_timeline
        assert (per.n_analytical, per.n_timeline, per.n_simulated) == \
            (batched.n_analytical, 0, batched.n_timeline)
        for res in (batched, per, on_torch):
            A.assert_tables_agree(res.columns, sim.columns, A.BATCHED_RTOL, oracle=True)

    def test_het_straggler_sync_k_and_fault_axes(self):
        grid = failure_grid()
        sim = A.simulated_table(grid, seed=11)
        assert_identical(sim, rsweep.sweep(ref_grid(grid), force_simulator=True,
                                           seed=11).columns)
        for got in (tsweep.sweep(grid, backend="numpy", seed=11).columns,
                    tsweep.sweep(grid, device=CPU, seed=11).columns):
            worst = A.assert_tables_agree(got, sim, A.BATCHED_RTOL, oracle=True)
            assert worst <= A.BATCHED_RTOL
        assert np.any(sim["t_p99_s"] > sim["iteration_time_s"] * (1 + 1e-3))

    def test_simulated_table_on_a_pool_equals_the_serial_oracle(self):
        grid = small_grid(collectives=("ring",), sync_ks=(None, 3), faults=(None, FAULT))
        assert_identical(A.simulated_table(grid, jobs=2, seed=4),
                         tsweep.sweep(grid, backend="numpy", force_simulator=True,
                                      seed=4).columns)

    def test_single_scenario_oracle_with_crashes(self):
        s = Scenario("alexnet", "v100-nvlink-ib", 8, "tensorflow",
                     het="het:1x0.5+7x1.0", sync_k=6, faults="fail:0.3@restart2x8")
        fast, sim = tsweep.evaluate_scenario(s, seed=2), \
            tsweep.evaluate_scenario(s, method="simulator", seed=2)
        for c in ORACLE_COLS:
            assert fast[c] == pytest.approx(sim[c], rel=1e-6), c


class TestDrivers:
    def test_iter_rows_and_streams_equal_reference(self, tmp_path, simonly):
        grid = small_grid(policies=("cntk", simonly, "bucketed-25mb"),
                          stragglers=(None, STRAGGLER))
        kw = dict(backend="numpy", chunk=5, seed=3)
        assert list(tsweep.iter_rows(grid, **kw)) == \
            list(rsweep.iter_rows(ref_grid(grid), **kw))
        for fn, name in ((tsweep.stream_csv, "t.csv"), (tsweep.stream_json, "t.json")):
            fn(grid, tmp_path / name, **kw)
        rsweep.stream(ref_grid(grid), csv_path=tmp_path / "r.csv",
                      json_path=tmp_path / "r.json", **kw)
        both = tsweep.stream(grid, csv_path=tmp_path / "b.csv",
                             json_path=tmp_path / "b.json", **kw)
        assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "r.csv").read_bytes() \
            == (tmp_path / "b.csv").read_bytes()
        docs = [json.loads((tmp_path / n).read_text()) for n in ("t.json", "r.json", "b.json")]
        for d in docs:
            d.pop("elapsed_s"), d.pop("scenarios_per_sec")
        assert docs[0] == docs[1] == docs[2]
        assert docs[0]["n_simulated"] == len(grid) // 3 > 0
        whole = json.loads(tsweep.sweep(grid, backend="numpy", seed=3).to_json())
        assert set(whole) - {"rows", "columns"} == set(tsweep.RESULT_META_KEYS)
        assert whole["rows"] == docs[0]["rows"]
        assert set(both) == set(tsweep.RESULT_META_KEYS)

    @pytest.mark.parametrize("backend", ["numpy", "torch"])
    def test_chunking_is_invisible(self, backend, tmp_path):
        grid = small_grid(stragglers=(None, STRAGGLER), faults=(None, FAULT))
        dev = CPU if backend == "torch" else None
        whole = tsweep.sweep(grid, backend=backend, device=dev, seed=6).columns
        for chunk in (1, 7, 64):
            assert_identical(tsweep.sweep(grid, backend=backend, device=dev,
                                          chunk=chunk, seed=6).columns, whole)
        # a scenario list chunked pads each chunk to its own deepest workload,
        # which may change a layer sum's last bit (the reference's too)
        scenarios = grid.expand()
        assert_identical(tsweep.sweep(scenarios, backend=backend, device=dev,
                                      chunk=len(grid), seed=6).columns, whole)
        chunked = tsweep.sweep(scenarios, backend=backend, device=dev, chunk=9,
                               seed=6).columns
        if backend == "numpy":
            assert_identical(chunked, rsweep.sweep([ref_scenario(s) for s in scenarios],
                                                   chunk=9, seed=6).columns)
        A.assert_tables_agree(chunked, whole, A.COALESCED_RTOL)
        meta = A.stream_matches_sweep(grid, tmp_path / "s.csv", chunk=13,
                                      backend=backend, device=dev, seed=6)
        assert meta["n_chunks"] == -(-len(grid) // 13) and meta["backend"] == backend
        if backend == "numpy":
            assert_identical(whole, rsweep.sweep(ref_grid(grid), seed=6).columns)

    def test_thread_pool_bit_identical_to_serial(self, simonly):
        grid = small_grid(policies=("caffe-mpi", simonly, "priority"),
                          stragglers=(None, STRAGGLER))
        serial = tsweep.sweep(grid, backend="numpy", seed=8).columns
        assert_identical(serial, rsweep.sweep(ref_grid(grid), seed=8).columns)
        for chunk in (1, 5, 1000):
            got = trt.concat_tables(list(tsweep.iter_tables(
                grid, backend="numpy", jobs=2, pool="thread", chunk=chunk, seed=8)))
            assert_identical(got, serial)

    def test_process_pool_and_sigkill_rescue(self):
        grid = small_grid()
        serial = tsweep.sweep(grid, backend="numpy").columns
        tparallel.warm_pool("process", jobs=2)
        assert_identical(tsweep.sweep(grid, backend="numpy", jobs=2).columns, serial)
        gen = tparallel.parallel_tables(grid, jobs=2, chunk=1, pool="process")
        tables = [next(gen)]                                   # in flight
        victim = next(iter(tparallel._POOLS[("process", 2)]._processes.values()))
        os.kill(victim.pid, signal.SIGKILL)
        tables.extend(gen)
        assert_identical(trt.concat_tables(tables), serial)

    def test_rescue_span_names_the_poison_index(self, monkeypatch):
        grid = small_grid()
        real = tparallel._eval_span

        def bomb(grid, lo, hi, warm, seed=0):
            if lo <= 5 < hi:
                raise ValueError("boom")
            return real(grid, lo, hi, warm, seed)

        monkeypatch.setattr(tparallel, "_eval_span", bomb)
        with pytest.raises(RuntimeError, match=r"flat index 5 of poison span \[0, 8\)"):
            tparallel._rescue_span(grid, 0, 8, 6, 0)
        monkeypatch.setattr(tparallel, "_eval_span", real)
        assert_identical(tparallel._rescue_span(grid, 0, 8, 6, 0),
                         rparallel._eval_span(ref_grid(grid), 0, 8, 6, 0))

    def test_span_plan_and_jobs_equal_reference(self):
        for n in (0, 1, 7, 100, 8193, 51840):
            for jobs in (1, 2, 3, 8):
                for chunk in (1, 16, 8192):
                    assert tparallel.span_plan(n, jobs, chunk) == \
                        rparallel.span_plan(n, jobs, chunk)
        for jobs in (None, 0, 1, 2, -1, 5):
            assert tparallel.resolve_jobs(jobs) == rparallel.resolve_jobs(jobs)
        with pytest.raises(ValueError, match="unknown pool"):
            tparallel._get_pool("fiber", 2)

    def test_jobs_is_a_no_op_on_the_torch_backend(self):
        grid = small_grid()
        pools = dict(tparallel._POOLS)
        assert_identical(tsweep.sweep(grid, device=CPU, jobs=4).columns,
                         tsweep.sweep(grid, device=CPU).columns)
        assert tparallel._POOLS == pools

    def test_to_dataframe(self):
        grid = small_grid()
        ours = tsweep.sweep(grid, backend="numpy").to_dataframe()
        theirs = rsweep.sweep(ref_grid(grid)).to_dataframe()
        assert ours.equals(theirs) and list(ours.columns) == list(COLUMNS)


class TestTorchRefusals:
    def test_torch_refuses_the_host_paths(self, tmp_path):
        grid = small_grid()
        for kw in (dict(batched=False), dict(force_simulator=True)):
            for call in (lambda: tsweep.sweep(grid, device=CPU, **kw),
                         lambda: list(tsweep.iter_rows(grid, device=CPU, **kw)),
                         lambda: tsweep.stream_csv(grid, tmp_path / "x.csv",
                                                   device=CPU, **kw)):
                with pytest.raises(ValueError, match="backend='numpy'"):
                    call()
        assert not (tmp_path / "x.csv").exists()
        with pytest.raises(ValueError, match="device"):
            tsweep.sweep(grid, backend="numpy", force_simulator=True, device=CPU)

    def test_simulator_only_grid(self, simonly):
        grid = small_grid(policies=("caffe-mpi", simonly))
        with pytest.raises(ValueError, match="_simonly"):
            tsweep.sweep(grid, device=CPU)
        with pytest.raises(ValueError, match="_simonly"):
            tsweep.sweep(grid.expand(), device=CPU)
        res = tsweep.sweep(grid, backend="numpy")
        assert res.n_simulated == len(grid) // 2
        assert_identical(res.columns, rsweep.sweep(ref_grid(grid)).columns)

    def test_no_cuda_never_falls_back(self, monkeypatch, tmp_path):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        grid = small_grid()
        for call in (lambda: tsweep.sweep(grid), lambda: tsweep.sweep(grid.expand()),
                     lambda: tsweep.stream_csv(grid, tmp_path / "x.csv")):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


class TestCli:
    ARGS = ["--workloads", "alexnet,trace:alexnet-k80", "--clusters", "v100-nvlink-ib",
            "--workers", "4", "--policies", "cntk,caffe-mpi,bucketed-4mb,priority",
            "--collectives", "ring", "--sync-k", "none,3",
            "--faults", "none,fail:0.2@restart1.5x8", "--top", "0"]

    def _both(self, capsys, ours, theirs):
        from repro.launch.sweep import main as ref_main
        from repro_torch.sweep import main

        assert main(ours) == 0
        a = capsys.readouterr().out.splitlines()
        assert ref_main(theirs) == 0
        b = capsys.readouterr().out.splitlines()
        return a, b

    @pytest.mark.parametrize("flag", ["--force-simulator", "--per-scenario"])
    def test_host_paths_print_the_reference_table(self, capsys, flag):
        a, b = self._both(capsys, [*self.ARGS, "--backend", "numpy", flag],
                          [*self.ARGS, flag])
        assert a[0] == b[0] and a[2:] == b[2:] and len(a) == 5 + 32
        assert "simulated" in a[1]

    def test_stream_and_chunk_flags(self, capsys, tmp_path):
        a, b = self._both(capsys, [*self.ARGS, "--backend", "numpy", "--stream",
                                   "--csv", str(tmp_path / "t.csv"), "--chunk", "7"],
                          [*self.ARGS, "--stream", "--csv", str(tmp_path / "r.csv"),
                           "--chunk", "7"])
        assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "r.csv").read_bytes()
        assert a[-1].startswith("streamed 32 rows")
        from repro_torch.sweep import main

        assert main([*self.ARGS, "--device", "cpu", "--stream", "--csv",
                     str(tmp_path / "c.csv"), "--chunk", "7", "--jobs", "2"]) == 0
        want = A.read_csv_table(tmp_path / "r.csv")
        A.assert_tables_agree(A.read_csv_table(tmp_path / "c.csv"), want, A.BATCHED_RTOL)

    def test_flag_errors_exit_2(self, capsys):
        from repro_torch.sweep import main

        assert main(["--device", "cpu", "--stream"]) == 2
        assert main(["--device", "cpu", "--per-scenario"]) == 2
        assert main(["--device", "cpu", "--force-simulator"]) == 2
        assert main(["--device", "cpu", "--sync-k", "-3"]) == 2
        err = capsys.readouterr().err
        assert err.count("error:") == 4 and "--backend numpy" in err
