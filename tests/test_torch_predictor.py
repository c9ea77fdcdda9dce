"""The port's copy of the DAG model against the reference's, on the CPU.

``repro_torch.core`` (``policies``, ``dag``, ``simulator``,
``predictor``: ``predict_sync_policy``, ``predict``, ``predict_workload``,
``scaling_curve``) and the trace reader
(``repro_torch.traces.format.read_trace``, ``Trace.to_iteration_costs``)
are plain Python copies of ``repro.core`` and ``repro.traces.format``
with the same arithmetic in the same order, so every result here is
required equal with ``==``, not within a tolerance.  Inputs are seeded
numpy draws: 1-40 layers, random forward, backward and all-reduce times
and gradient payloads, non-zero ``t_io``, ``t_h2d`` and ``t_u``, on 1, 2
and 8 workers.  The workload predictions run on paper CNNs (``cnn:``),
Table VI (``trace:alexnet-k80``) and a trace the port's generator wrote
(``trace:<file>``).
"""
import dataclasses

import numpy as np
import pytest

from repro.comm.sync import DEFAULT_BUCKET_BYTES as J_BUCKET_BYTES
from repro.core import bucketsim as jbucketsim
from repro.core import dag as jdag
from repro.core import policies as jpolicies
from repro.core import predictor as jpredictor
from repro.core import simulator as jsim
from repro.measure import calibrate as jcal
from repro.traces import format as jformat
from repro.core import hardware as jhardware
from repro.traces import bundled as jbundled
from repro.traces.bundled import ALEXNET_K80
from repro_torch.comm.sync import DEFAULT_BUCKET_BYTES
from repro_torch.core import bucketsim as tbucketsim
from repro_torch.core import dag as tdag
from repro_torch.core import hardware as thardware
from repro_torch.core import policies as tpolicies
from repro_torch.core import predictor as tpredictor
from repro_torch.core import simulator as tsim
from repro_torch.measure import calibrate as tcal
from repro_torch.traces import bundled as tbundled
from repro_torch.traces import format as tformat

WORKERS = (1, 2, 8)
SYNC_POLICIES = ("at_end", "wfbp", "bucketed")


def _cost_fields(seed: int) -> dict:
    """Seeded per-layer times (seconds) and payloads (bytes): 1-40 layers,
    a few with no gradient (t_c 0 and payload 0, no comm task)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 41))
    grad = rng.uniform(1e5, 6e7, n)
    t_c = rng.uniform(1e-4, 5e-2, n)
    none = rng.random(n) < 0.15
    grad[none], t_c[none] = 0.0, 0.0
    return dict(t_f=rng.uniform(1e-4, 2e-2, n).tolist(), t_b=rng.uniform(2e-4, 4e-2, n).tolist(),
                t_c=t_c.tolist(), t_io=float(rng.uniform(1e-3, 2e-2)),
                t_h2d=float(rng.uniform(1e-4, 5e-3)), t_u=float(rng.uniform(1e-3, 3e-2)),
                grad_bytes=grad.tolist())


def _fit(seed: int) -> tuple[float, float]:
    rng = np.random.default_rng(1000 + seed)
    return float(rng.uniform(0.0, 2e-3)), float(rng.uniform(5e8, 5e10))


def test_bucket_threshold_is_the_reference_constant():
    assert DEFAULT_BUCKET_BYTES == J_BUCKET_BYTES


class TestPolicies:
    def test_every_policy_equals_the_reference(self):
        assert list(tpolicies.ALL_POLICIES) == list(jpolicies.ALL_POLICIES)
        for name, pol in tpolicies.ALL_POLICIES.items():
            ref = jpolicies.ALL_POLICIES[name]
            assert dataclasses.asdict(pol) == dataclasses.asdict(ref)
            assert pol.describe() == ref.describe()
            assert tpolicies.get_policy(name) == pol
        assert list(tpolicies.FRAMEWORK_POLICIES) == list(jpolicies.FRAMEWORK_POLICIES)
        assert dataclasses.asdict(tpolicies.PRIORITY) == dataclasses.asdict(jpolicies.PRIORITY)

    def test_unknown_policy_raises_like_the_reference(self):
        with pytest.raises(KeyError, match="unknown policy"):
            jpolicies.get_policy("nope")
        with pytest.raises(KeyError, match="unknown policy"):
            tpolicies.get_policy("nope")


class TestDag:
    @pytest.mark.parametrize("seed", range(8))
    def test_bucket_partition_equals_reference(self, seed):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(1, 41))
        mask = (rng.random(n) > 0.2).tolist()
        payload = rng.uniform(0, 4e7, n).tolist()
        # whole-MB payloads, so that a bucket also closes exactly at its
        # threshold
        whole = rng.integers(0, 5, n).astype(float) * 1e6
        for bb in (None, 1e6, 2e6, 25e6, 1e8, float("inf")):
            for pl in (payload, whole.tolist(), None):
                assert tbucketsim.bucket_partition(mask, pl, bb) == \
                    jbucketsim.bucket_partition(mask, pl, bb)

    @pytest.mark.parametrize("policy", sorted(jpolicies.ALL_POLICIES))
    @pytest.mark.parametrize("n_workers", WORKERS)
    def test_built_graph_equals_reference(self, policy, n_workers):
        """Every task (name, kind, duration, channel, iteration, layer,
        worker, priority, payload) and every edge, over two iterations."""
        fields = _cost_fields(3)
        scale_args = _fit(3)
        j = jdag.build_ssgd_dag(jdag.IterationCosts(**fields), n_workers,
                                jpolicies.ALL_POLICIES[policy], n_iterations=2,
                                comm_scale=jcal.comm_scale_from_fit(*scale_args))
        t = tdag.build_ssgd_dag(tdag.IterationCosts(**fields), n_workers,
                                tpolicies.ALL_POLICIES[policy], n_iterations=2,
                                comm_scale=tcal.comm_scale_from_fit(*scale_args))
        assert len(t.tasks) == len(j.tasks)
        for tid, jt in j.tasks.items():
            tt = t.tasks[tid]
            assert (tt.name, tt.kind.value, tt.duration, tt.channel, tt.iteration, tt.layer,
                    tt.worker, tt.priority, tt.nbytes) == \
                (jt.name, jt.kind.value, jt.duration, jt.channel, jt.iteration, jt.layer,
                 jt.worker, jt.priority, jt.nbytes), tid
            assert t.preds[tid] == j.preds[tid] and t.succs[tid] == j.succs[tid], tid

    def test_costs_validate_like_the_reference(self):
        for kw in (dict(t_f=[1.0], t_b=[1.0, 2.0], t_c=[1.0]),
                   dict(t_f=[1.0], t_b=[1.0], t_c=[1.0], grad_bytes=[1.0, 2.0])):
            with pytest.raises(ValueError):
                jdag.IterationCosts(**kw)
            with pytest.raises(ValueError):
                tdag.IterationCosts(**kw)
        with pytest.raises(ValueError, match="negative duration"):
            tdag.DAG().add_task("x", tdag.TaskKind.COMPUTE, -1.0, "gpu:0")


class TestSimulator:
    @pytest.mark.parametrize("policy", sorted(jpolicies.ALL_POLICIES))
    def test_simulate_policy_equals_reference(self, policy):
        """``steady_iteration_time()``, ``utilization(NET_CHANNEL)`` and
        ``n_iterations_used``, with and without the steady-state stop and a
        measured-fit ``comm_scale``, on 1, 2 and 8 workers."""
        for seed in range(3):
            fields = _cost_fields(seed)
            fit = _fit(seed)
            for n_workers in WORKERS:
                for with_scale in (False, True):
                    for auto in (False, True):
                        j = jsim.simulate_policy(
                            jdag.IterationCosts(**fields), n_workers,
                            jpolicies.ALL_POLICIES[policy], n_iterations=6,
                            comm_scale=jcal.comm_scale_from_fit(*fit) if with_scale else None,
                            auto_steady=auto)
                        t = tsim.simulate_policy(
                            tdag.IterationCosts(**fields), n_workers,
                            tpolicies.ALL_POLICIES[policy], n_iterations=6,
                            comm_scale=tcal.comm_scale_from_fit(*fit) if with_scale else None,
                            auto_steady=auto)
                        key = (seed, n_workers, with_scale, auto)
                        assert t.steady_iteration_time() == j.steady_iteration_time(), key
                        assert t.utilization(tdag.NET_CHANNEL) == \
                            j.utilization(jdag.NET_CHANNEL), key
                        assert t.n_iterations_used == j.n_iterations_used, key
                        assert t.makespan == j.makespan and t.iteration_times() == \
                            j.iteration_times(), key

    def test_empty_schedule_raises_like_the_reference(self):
        costs = dict(t_f=[1e-3], t_b=[1e-3], t_c=[1e-3])
        for dag_mod, sim_mod, pol in ((jdag, jsim, jpolicies.CNTK),
                                      (tdag, tsim, tpolicies.CNTK)):
            dag = dag_mod.build_ssgd_dag(dag_mod.IterationCosts(**costs), 2, pol,
                                         n_iterations=0)
            with pytest.raises(ValueError, match="no 'update' task"):
                sim_mod.simulate(dag).steady_iteration_time()

    def test_steady_detection_equals_reference(self):
        for fin in ([1.0, 2.0, 3.0], [0.0, 1.0, 2.0, 3.0], [0.0, 1.0, 2.5, 3.0],
                    [0.0, 0.0, 0.0, 0.0], [0.0, 1.0, 2.0, 3.0 + 1e-12],
                    [0.0, 0.1, 0.25, 0.3], [0.0, 1e-3, 2e-3, 3e-3], [5.0, 5.0, 5.0, 5.5]):
            assert tsim._steady_converged(fin, tsim.STEADY_RTOL) == \
                jsim._steady_converged(fin, jsim.STEADY_RTOL)
        assert tsim.STEADY_RTOL == jsim.STEADY_RTOL


class TestPredictSyncPolicy:
    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize("n_workers", WORKERS)
    def test_equals_reference(self, seed, n_workers):
        """Every sync policy, with no ``comm_scale`` and with a random
        alpha-beta fit's, at the default 25 MB threshold and at 2 MB (so
        that ``bucketed`` fuses several buckets)."""
        fields = _cost_fields(seed)
        fit = _fit(seed)
        for bucket_bytes in (DEFAULT_BUCKET_BYTES, 2e6):
            for with_scale in (False, True):
                for pol in SYNC_POLICIES:
                    j = jpredictor.predict_sync_policy(
                        jdag.IterationCosts(**fields), n_workers, pol,
                        comm_scale=jcal.comm_scale_from_fit(*fit) if with_scale else None,
                        bucket_bytes=bucket_bytes)
                    t = tpredictor.predict_sync_policy(
                        tdag.IterationCosts(**fields), n_workers, pol,
                        comm_scale=tcal.comm_scale_from_fit(*fit) if with_scale else None,
                        bucket_bytes=bucket_bytes)
                    assert t == j, (pol, bucket_bytes, with_scale)
                    assert np.isfinite(t) and t > 0

    def test_small_threshold_makes_several_buckets(self):
        fields = _cost_fields(0)
        pol = dataclasses.replace(tpredictor.SYNC_POLICY_MODELS["bucketed"], bucket_bytes=2e6)
        buckets = tdag._bucketize(tdag.IterationCosts(**fields), pol, None)
        assert 1 < len(buckets) < sum(c > 0 for c in fields["t_c"])

    def test_models_equal_the_reference(self):
        assert list(tpredictor.SYNC_POLICY_MODELS) == list(jpredictor.SYNC_POLICY_MODELS)
        for name, pol in tpredictor.SYNC_POLICY_MODELS.items():
            assert dataclasses.asdict(pol) == \
                dataclasses.asdict(jpredictor.SYNC_POLICY_MODELS[name])

    def test_unknown_sync_policy_raises_like_the_reference(self):
        fields = _cost_fields(0)
        for mod, dag_mod in ((jpredictor, jdag), (tpredictor, tdag)):
            with pytest.raises(ValueError, match="unknown sync policy 'ring'"):
                mod.predict_sync_policy(dag_mod.IterationCosts(**fields), 2, "ring")


class TestTraceReader:
    def test_bundled_alexnet_reads_like_the_reference(self, tmp_path):
        """Table VI's AlexNet on K80s, written by the reference: the same
        trace, and the same costs with its ``data`` layer as ``t_io``."""
        path = tmp_path / "alexnet.trace"
        jformat.write_trace(ALEXNET_K80, path)
        j, t = jformat.read_trace(path), tformat.read_trace(path)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        jc = j.to_iteration_costs(t_u=0.02)
        tc = t.to_iteration_costs(t_u=0.02)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.t_io == ALEXNET_K80.iterations[0][0].forward_us * 1e-6 > 0
        assert tc.num_layers == ALEXNET_K80.num_layers - 1
        for kw in (dict(data_layer_as_io=False), dict(t_io=0.5, t_h2d=0.1)):
            assert dataclasses.asdict(t.to_iteration_costs(**kw)) == \
                dataclasses.asdict(j.to_iteration_costs(**kw))

    def test_several_iterations_average_like_the_reference(self, tmp_path):
        rng = np.random.default_rng(7)
        rows = [[(i, f"l{i}", *rng.uniform(0, 1e4, 3).tolist(), float(rng.integers(0, 1e8)))
                 for i in range(5)] for _ in range(3)]
        trace = tformat.Trace("n", "c", tuple(tuple(tformat.LayerRecord(*r) for r in it)
                                              for it in rows), batch_per_gpu=4)
        path = tmp_path / "t.trace"
        tformat.write_trace(trace, path)
        j, t = jformat.read_trace(path), tformat.read_trace(path)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert dataclasses.asdict(t) == dataclasses.asdict(trace)
        assert [dataclasses.asdict(r) for r in t.mean_iteration()] == \
            [dataclasses.asdict(r) for r in j.mean_iteration()]
        assert dataclasses.asdict(t.to_iteration_costs()) == \
            dataclasses.asdict(j.to_iteration_costs())

    @pytest.mark.parametrize("text,match", [
        ("# batch: two\n0\ta\t1\t1\t1\t1\n", "'# batch:' value 'two' is not an integer"),
        ("# bytes-per-sample: many\n0\ta\t1\t1\t1\t1\n",
         "'# bytes-per-sample:' value 'many' is not a number"),
        ("# network: x\n", "empty trace file"),
        ("", "empty trace file"),
    ])
    def test_malformed_files_raise_the_reference_errors(self, tmp_path, text, match):
        path = tmp_path / "bad.trace"
        path.write_text(text)
        with pytest.raises(ValueError, match=match) as jerr:
            jformat.read_trace(path)
        with pytest.raises(ValueError, match=match) as terr:
            tformat.read_trace(path)
        assert str(terr.value) == str(jerr.value)


class TestSharedCompute:
    @pytest.mark.parametrize("policy", sorted(jpolicies.ALL_POLICIES))
    @pytest.mark.parametrize("n_workers", (2, 8))
    def test_graph_and_time_equal_reference(self, policy, n_workers):
        """``shared_compute=True`` (every worker's compute on one channel):
        every task and edge over five iterations, and the simulated steady
        iteration time, as the §V-D validation builds it."""
        fields = _cost_fields(5)
        j = jdag.build_ssgd_dag(jdag.IterationCosts(**fields), n_workers,
                                jpolicies.ALL_POLICIES[policy], n_iterations=5,
                                shared_compute=True)
        t = tdag.build_ssgd_dag(tdag.IterationCosts(**fields), n_workers,
                                tpolicies.ALL_POLICIES[policy], n_iterations=5,
                                shared_compute=True)
        assert len(t.tasks) == len(j.tasks)
        for tid, jt in j.tasks.items():
            tt = t.tasks[tid]
            assert (tt.name, tt.duration, tt.channel, tt.priority) == \
                (jt.name, jt.duration, jt.channel, jt.priority), tid
            assert t.preds[tid] == j.preds[tid] and t.succs[tid] == j.succs[tid], tid
        assert {tt.channel for tt in t.tasks.values() if tt.kind == tdag.TaskKind.COMPUTE} \
            == {"gpu:shared"}
        jt_s = jsim.simulate(j).steady_iteration_time()
        assert tsim.simulate(t).steady_iteration_time() == jt_s
        ideal = tdag.build_ssgd_dag(tdag.IterationCosts(**fields), n_workers,
                                    tpolicies.ALL_POLICIES[policy], n_iterations=5)
        assert tsim.simulate(ideal).steady_iteration_time() <= jt_s


def test_total_grad_bytes_equals_reference():
    assert tbundled.TOTAL_GRAD_BYTES == jbundled.TOTAL_GRAD_BYTES == 243_860_896


@pytest.fixture(scope="module")
def generated_trace(tmp_path_factory):
    """A trace the port's generator wrote: a small ResNet on the CPU, its
    batch recorded, comm priced by the K80 cluster."""
    from repro_torch.models import cnn
    from repro_torch.traces.generate import generate_trace

    layers, x0 = cnn.resnet_timed_layers(0, input_hw=32, depth_per_stage=(1, 1), width=4,
                                         device="cpu")
    trace = generate_trace(layers, x0.expand(2, -1, -1, -1).contiguous(), "resnet-mini",
                           n_iterations=2, repeats=1,
                           comm_time_fn=lambda b: thardware.K80_CLUSTER.allreduce_time(b, 16))
    path = tmp_path_factory.mktemp("gen") / "resnet-mini.trace"
    tformat.write_trace(dataclasses.replace(trace, batch_per_gpu=2), path)
    return f"trace:{path}"


WORKLOADS = ("alexnet", "cnn:resnet50", "googlenet", "trace:alexnet-k80", "generated")
PREDICT_POLICIES = ("caffe-mpi", "cntk", "naive", "bucketed-25mb", "priority")


def _workload(name, generated_trace):
    return generated_trace if name == "generated" else name


class TestPredictWorkload:
    @pytest.mark.parametrize("workload", WORKLOADS)
    @pytest.mark.parametrize("cluster", ("k80-pcie-10gbe", "v100-nvlink-ib"))
    def test_equals_reference(self, workload, cluster, generated_trace):
        """Every field of the :class:`Prediction`, on 1, 2 and 8 workers, ring
        and hierarchical all-reduce."""
        wl = _workload(workload, generated_trace)
        for pol in PREDICT_POLICIES:
            for n in WORKERS:
                for coll in ("ring", "hierarchical"):
                    j = jpredictor.predict_workload(wl, jhardware.CLUSTERS[cluster], n,
                                                    jpolicies.ALL_POLICIES[pol],
                                                    collective=coll)
                    t = tpredictor.predict_workload(wl, thardware.CLUSTERS[cluster], n,
                                                    tpolicies.ALL_POLICIES[pol],
                                                    collective=coll)
                    assert dataclasses.asdict(t) == dataclasses.asdict(j), (pol, n, coll)
        assert tpredictor.predict_cnn is tpredictor.predict_workload

    @pytest.mark.parametrize("workload", WORKLOADS)
    def test_scaling_curve_equals_reference(self, workload, generated_trace):
        wl = _workload(workload, generated_trace)
        for pol in ("caffe-mpi", "bucketed-25mb"):
            j = jpredictor.scaling_curve(wl, jhardware.CLUSTERS["v100-nvlink-ib"],
                                         jpolicies.ALL_POLICIES[pol], batch_per_gpu=16)
            t = tpredictor.scaling_curve(wl, thardware.CLUSTERS["v100-nvlink-ib"],
                                         tpolicies.ALL_POLICIES[pol], batch_per_gpu=16)
            assert [dataclasses.asdict(x) for x in t] == [dataclasses.asdict(x) for x in j]
            assert [x.n_workers for x in t] == [1, 2, 4, 8, 16]

    @pytest.mark.parametrize("seed", range(4))
    def test_predict_equals_reference(self, seed):
        """:func:`predict` on seeded costs, with and without a cluster's
        comm pricing and single-GPU costs of their own."""
        fields = _cost_fields(seed)
        one = dict(fields, t_f=[2 * x for x in fields["t_f"]])
        for pol in PREDICT_POLICIES:
            for n in WORKERS:
                for name in (None, "v100-nvlink-ib"):
                    kw = dict(batch_per_gpu=4, warm_iterations=5)
                    j = jpredictor.predict(
                        jdag.IterationCosts(**fields), n, jpolicies.ALL_POLICIES[pol],
                        costs_1gpu=jdag.IterationCosts(**one),
                        cluster=jhardware.CLUSTERS[name] if name else None, **kw)
                    t = tpredictor.predict(
                        tdag.IterationCosts(**fields), n, tpolicies.ALL_POLICIES[pol],
                        costs_1gpu=tdag.IterationCosts(**one),
                        cluster=thardware.CLUSTERS[name] if name else None, **kw)
                    assert dataclasses.asdict(t) == dataclasses.asdict(j), (pol, n, name)
