"""The port's copies of the DAG model's sweep modules pinned ``==`` to the
reference's (``repro.core.{hardware,analytical,bucketsim,het,costmodel,
archcost,workloads,scenarios,batched}``, ``repro.traces.bundled``, the
DAG's graph queries), their torch paths held to the NumPy ones, the
framework-comparison twin's rows and printout against
``examples/framework_comparison.py``, the
``torch:`` workload provider against the reference's ``trace:`` on a trace
the port's measurement wrote, and the torch twin of the WFBP prefix-max
residual against both reference forms."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from strategies import wfbp_layer_times

from repro.core import analytical as janalytical
from repro.core import archcost as jarchcost
from repro.core import batched as jbatched
from repro.core import bucketsim as jbucketsim
from repro.core import costmodel as jcostmodel
from repro.core import dag as jdag
from repro.core import hardware as jhw
from repro.core import het as jhet
from repro.core import policies as jpolicies
from repro.core import scenarios as jscen
from repro.core import sweep as jsweep
from repro.core import workloads as jworkloads
from repro.traces import bundled as jbundled
from repro_torch.configs import ARCH_IDS
from repro_torch.core import analytical as tanalytical
from repro_torch.core import archcost as tarchcost
from repro_torch.core import batched as tbatched
from repro_torch.core import bucketsim as tbucketsim
from repro_torch.core import costmodel as tcostmodel
from repro_torch.core import dag as tdag
from repro_torch.core import hardware as thw
from repro_torch.core import policies as tpolicies
from repro_torch.core import het as thet
from repro_torch.core import scenarios as tscen
from repro_torch.core import sweep as tsweep
from repro_torch.core import workloads as tworkloads
from repro_torch.core import xputil
from repro_torch.traces import bundled as tbundled

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
EPS = np.finfo(np.float64).eps


def _t(x):
    return torch.as_tensor(np.asarray(x), device="cpu")


def _equal(a, b):
    """NumPy results equal in value, dtype and shape."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _links(rng, n):
    return (rng.integers(1, 300, n), rng.uniform(1e8, 1e11, n),
            rng.uniform(0.0, 1e-4, n))


class TestHardware:
    @pytest.mark.parametrize("seed", range(3))
    def test_coefficient_and_time_models_equal_reference(self, seed):
        rng = np.random.default_rng(seed)
        n, bw, lat = _links(rng, 64)
        n[:5] = (0, 1, 2, 4, 8)
        gpn = rng.integers(1, 17, 64)
        bw2, lat2 = rng.uniform(1e8, 1e11, 64), rng.uniform(0, 1e-4, 64)
        nbytes = rng.uniform(1.0, 1e9, 64)
        nf = n.astype(np.float64)
        for name, args in (
                ("ring_allreduce_coeffs", (nf, bw, lat)),
                ("tree_allreduce_coeffs", (n, bw, lat)),
                ("hierarchical_allreduce_coeffs", (n, gpn, bw, lat, bw2, lat2))):
            got = getattr(thw, name)(*args)
            want = getattr(jhw, name)(*args)
            for g, w in zip(got, want):
                _equal(g, w)
            # the torch namespace: the same IEEE operations, the same bits
            for g, w in zip(getattr(thw, name)(*map(_t, args)), want):
                assert g.dtype == torch.float64
                np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        for name, args in (
                ("ring_allreduce_time", (nbytes, nf, bw, lat)),
                ("tree_allreduce_time", (nbytes, n, bw, lat)),
                ("hierarchical_allreduce_time", (nbytes, n, gpn, bw, lat, bw2, lat2))):
            _equal(getattr(thw, name)(*args), getattr(jhw, name)(*args))
            np.testing.assert_array_equal(
                getattr(thw, name)(*map(_t, args)).numpy(),
                getattr(jhw, name)(*args), err_msg=name)
        for s in (1, 2, 7, 16, 64):
            assert thw.ring_allreduce_time(1e6, s, 1e9, 1e-5) == \
                jhw.ring_allreduce_time(1e6, s, 1e9, 1e-5)
            assert thw.hierarchical_allreduce_time(1e6, s, 4, 1e10, 1e-6, 1e9, 1e-5) == \
                jhw.hierarchical_allreduce_time(1e6, s, 4, 1e10, 1e-6, 1e9, 1e-5)

    def test_slowest_link_and_ceil_log2_on_both_namespaces(self):
        rng = np.random.default_rng(4)
        bw, lat = rng.uniform(1, 2, (5, 7)), rng.uniform(0, 1, (5, 7))
        for g, w in zip(thw.slowest_link(bw, lat), jhw.slowest_link(bw, lat)):
            _equal(g, w)
        for g, w in zip(thw.slowest_link(_t(bw), _t(lat)), jhw.slowest_link(bw, lat)):
            np.testing.assert_array_equal(g.numpy(), w)
        # exact at powers of two (frexp), also on torch
        n = np.array([1, 2, 3, 4, 5, 7, 8, 9, 255, 256, 257, 1 << 20])
        want = np.ceil(np.log2(n))
        np.testing.assert_array_equal(thw._ceil_log2(n), want)
        ns = xputil.array_namespace(_t(n))
        np.testing.assert_array_equal(thw._ceil_log2(_t(n), ns).numpy(), want)

    def test_clusters_and_presets_field_for_field(self):
        assert list(thw.CLUSTERS) == list(jhw.CLUSTERS)
        for name in jhw.CLUSTERS:
            assert dataclasses.asdict(thw.CLUSTERS[name]) == \
                dataclasses.asdict(jhw.CLUSTERS[name]), name
        assert list(thw.INTERCONNECT_PRESETS) == list(jhw.INTERCONNECT_PRESETS)
        for name, (slot, link) in jhw.INTERCONNECT_PRESETS.items():
            tslot, tlink = thw.INTERCONNECT_PRESETS[name]
            assert (tslot, dataclasses.asdict(tlink)) == (slot, dataclasses.asdict(link))
        for preset in ("ib-100g@bw2@lat0.25", "10gbe@lat4", "nvlink@bw0.5"):
            slot, link = thw.resolve_interconnect_preset(preset)
            jslot, jlink = jhw.resolve_interconnect_preset(preset)
            assert (slot, dataclasses.asdict(link)) == (jslot, dataclasses.asdict(jlink))
        assert thw.COLLECTIVE_ALGORITHMS == jhw.COLLECTIVE_ALGORITHMS
        c, j = thw.CLUSTERS["v100-nvlink-ib"], jhw.CLUSTERS["v100-nvlink-ib"]
        for alg in thw.COLLECTIVE_ALGORITHMS:
            for n in (1, 2, 5, 16, 33):
                assert c.allreduce_time(3e7, n, alg) == j.allreduce_time(3e7, n, alg)


class TestAnalytical:
    @pytest.mark.parametrize("seed", range(3))
    def test_batched_reductions_equal_reference(self, seed):
        rng = np.random.default_rng(seed)
        t_b = rng.uniform(0, 5, (9, 13))
        t_c = rng.uniform(0, 5, (9, 13)) * (rng.uniform(size=(9, 13)) < 0.6)
        _equal(tanalytical.non_overlapped_comm_batch(t_b, t_c),
               janalytical.non_overlapped_comm_batch(t_b, t_c))
        inv = rng.uniform(0.5, 2, (6, 8)) * (rng.uniform(size=(6, 8)) < 0.8)
        bwm, latm = rng.uniform(0.25, 2, (6, 8)), rng.uniform(0.5, 4, (6, 8))
        for g, w in zip(tanalytical.worker_bottleneck(inv, bwm, latm),
                        janalytical.worker_bottleneck(inv, bwm, latm)):
            _equal(g, w)
        nlive = np.count_nonzero(inv, axis=1)
        inv_sorted = -np.sort(-inv, axis=1)       # live entries first
        k = rng.integers(0, 10, 6)
        keff = janalytical.effective_sync_k(k, nlive)
        _equal(tanalytical.effective_sync_k(k, nlive), keff)
        _equal(tanalytical.kth_order_statistic(inv_sorted, nlive, np.maximum(keff, 1)),
               janalytical.kth_order_statistic(inv_sorted, nlive, np.maximum(keff, 1)))
        for g, w in zip(tanalytical.worker_bottleneck_k(inv_sorted, bwm, latm, nlive, k),
                        janalytical.worker_bottleneck_k(inv_sorted, bwm, latm, nlive, k)):
            _equal(g, w)
            # and on the torch namespace
        for g, w in zip(tanalytical.worker_bottleneck_k(*map(_t, (inv_sorted, bwm, latm,
                                                                   nlive, k))),
                        janalytical.worker_bottleneck_k(inv_sorted, bwm, latm, nlive, k)):
            np.testing.assert_array_equal(g.numpy(), w)
        for g, w in zip(tanalytical.worker_bottleneck(_t(inv), _t(bwm), _t(latm)),
                        janalytical.worker_bottleneck(inv, bwm, latm)):
            np.testing.assert_array_equal(g.numpy(), w)

    def test_closed_forms_and_predicates_equal_reference(self):
        rng = np.random.default_rng(9)
        for _ in range(20):
            L = int(rng.integers(1, 12))
            kw = dict(t_f=list(rng.uniform(0, 1, L)), t_b=list(rng.uniform(0, 1, L)),
                      t_c=list(rng.uniform(0, 1, L) * (rng.uniform(size=L) < 0.6)),
                      t_io=float(rng.uniform(0, 3)), t_h2d=float(rng.uniform(0, 1)),
                      t_u=float(rng.uniform(0, 1)))
            tc, jc = tdag.IterationCosts(**kw), jdag.IterationCosts(**kw)
            for name in jpolicies.ALL_POLICIES:
                p, jp = tpolicies.ALL_POLICIES[name], jpolicies.ALL_POLICIES[name]
                assert tanalytical.has_closed_form(p) == janalytical.has_closed_form(jp)
                assert tanalytical.has_timeline_form(p) == janalytical.has_timeline_form(jp)
                assert tanalytical.closed_form(tc, p) == janalytical.closed_form(jc, jp)
            for fn in ("eq2_naive_ssgd", "eq3_io_overlap", "eq5_wfbp",
                       "eq3_late_h2d", "eq5_late_h2d"):
                assert getattr(tanalytical, fn)(tc) == getattr(janalytical, fn)(jc), fn


class TestBucketsim:
    @pytest.mark.parametrize("seed", range(3))
    def test_bucket_structure_and_residual_equal_reference(self, seed):
        rng = np.random.default_rng(seed)
        grad = rng.uniform(1e5, 8e7, (4, 15)) * (rng.uniform(size=(4, 15)) < 0.6)
        for bb in (None, 1.0, 1e6, 25e6, 1e9):
            assert tbucketsim.bucket_partition(grad[0] > 0, grad[0], bb) == \
                jbucketsim.bucket_partition(grad[0] > 0, grad[0], bb)
            assert tbucketsim.bucket_layers(grad[1], bb) == \
                jbucketsim.bucket_layers(grad[1], bb)
            bt, jbt = tbucketsim.bucket_table(grad, bb), jbucketsim.bucket_table(grad, bb)
            for f in ("nbytes", "release_layer", "mask"):
                _equal(getattr(bt, f), getattr(jbt, f))
            for g, w in zip(tbucketsim.suffix_tables(bt), jbucketsim.suffix_tables(jbt)):
                _equal(g, w)
            t_b = rng.uniform(0, 5, (4, 15))
            dur = rng.uniform(0, 3, bt.nbytes.shape)
            for ov in (True, False):
                want = jbucketsim.timeline_residual(t_b, dur, jbt.release_layer,
                                                    jbt.mask, ov)
                _equal(tbucketsim.timeline_residual(t_b, dur, bt.release_layer,
                                                    bt.mask, ov), want)
                got = tbucketsim.timeline_residual(_t(t_b), _t(dur), _t(bt.release_layer),
                                                   _t(bt.mask), ov)
                np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                           atol=8 * EPS * (t_b.sum(1) + dur.sum(1)).max())

    def test_dag_uses_the_shared_partition(self):
        assert tdag.bucket_partition is tbucketsim.bucket_partition


class TestHet:
    SPECS = ("het:1x0.5+3x1.0", "het:2x1.0@bw0.5", "het:1x0.7@lat2.0+1x1.3",
             "het:3x0.25@bw2@lat0.5+1x2")

    def test_profiles_and_worker_tables_equal_reference(self):
        pairs, jpairs = [], []
        for spec in self.SPECS + (None,):
            p, jp = thet.parse_het_profile(spec), jhet.parse_het_profile(spec)
            assert (p is None) == (jp is None)
            if p is not None:
                assert dataclasses.asdict(p) == dataclasses.asdict(jp)
            assert thet.normalize_het(spec) == jhet.normalize_het(spec)
            for n in (1, 3, 8, 17):
                for g, w in zip(thet.worker_vectors(p, n), jhet.worker_vectors(jp, n)):
                    _equal(g, w)
                pairs.append((p, n))
                jpairs.append((jp, n))
        got, want = thet.worker_table_rows(pairs), jhet.worker_table_rows(jpairs)
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
        for bad in ("het:", "het:0x1", "het:1x-1", "het:2x1@warp3"):
            with pytest.raises(ValueError):
                jhet.parse_het_profile(bad)
            with pytest.raises(ValueError):
                thet.parse_het_profile(bad)

    def test_straggler_and_fault_draws_equal_reference(self):
        for spec in ("lognormal:0.25x64", "exp:0.5x16", "lognormal:0x8", None):
            s, js = thet.parse_straggler(spec), jhet.parse_straggler(spec)
            assert thet.normalize_straggler(spec) == jhet.normalize_straggler(spec)
            if s is None:
                assert js is None
                continue
            assert dataclasses.asdict(s) == dataclasses.asdict(js)
            for n, seed in ((4, 0), (16, 7)):
                _equal(s.draw_matrix(n, seed), js.draw_matrix(n, seed))
        for spec in ("fail:0.1@restart1.5x16", "fail:0.5@restart0.25x8", "fail:0x8",
                     "fail:0.3@restart0x8", "fail:0.01"):
            f, jf = thet.parse_fault(spec), jhet.parse_fault(spec)
            assert dataclasses.asdict(f) == dataclasses.asdict(jf)
            assert thet.normalize_fault(spec) == jhet.normalize_fault(spec)
            for n, seed in ((4, 0), (9, 3)):
                _equal(f.crash_matrix(n, seed), jf.crash_matrix(n, seed))
        assert thet.restart_penalty_s(3e9) == jhet.restart_penalty_s(3e9)


class TestWorkloadTables:
    @staticmethod
    def _assert_tables_equal(got, want, name_of=lambda n: n):
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if f.name == "name":
                assert a == name_of(b)
            elif isinstance(b, np.ndarray):
                _equal(a, b)
            else:
                assert a == b, f.name

    @pytest.mark.parametrize("name", ["alexnet", "cnn:googlenet", "cnn:resnet50",
                                      "trace:alexnet-k80",
                                      *(f"llm:{a}" for a in ARCH_IDS)])
    def test_tables_equal_reference(self, name):
        self._assert_tables_equal(tworkloads.resolve_workload(name),
                                  jworkloads.resolve_workload(name))

    def test_cnn_layers_and_costs_equal_reference(self):
        assert list(tcostmodel.CNN_WORKLOADS) == list(jcostmodel.CNN_WORKLOADS)
        for name, (build, batch, bps) in tcostmodel.CNN_WORKLOADS.items():
            jbuild, jbatch, jbps = jcostmodel.CNN_WORKLOADS[name]
            assert [dataclasses.asdict(l) for l in build()] == \
                [dataclasses.asdict(l) for l in jbuild()]
            assert (batch, bps) == (jbatch, jbps)
            assert tcostmodel.total_params(build()) == jcostmodel.total_params(jbuild())
        c, j = thw.CLUSTERS["k80-pcie-10gbe"], jhw.CLUSTERS["k80-pcie-10gbe"]
        assert tcostmodel.update_time(1e8, c) == jcostmodel.update_time(1e8, j)
        for alg in thw.COLLECTIVE_ALGORITHMS:
            assert tcostmodel.comm_scale_fn(c, 8, alg)(5e6, 0.0) == \
                jcostmodel.comm_scale_fn(j, 8, alg)(5e6, 0.0)

    @pytest.mark.parametrize("arch", ARCH_IDS)
    def test_archcost_equals_reference(self, arch):
        from repro.configs import get_config as jget
        from repro_torch.configs import get_config

        cfg, jcfg = get_config(arch), jget(arch)
        assert tarchcost.param_counts(cfg) == jarchcost.param_counts(jcfg)
        assert [dataclasses.asdict(b) for b in tarchcost.block_cost_table(cfg, 4096)] == \
            [dataclasses.asdict(b) for b in jarchcost.block_cost_table(jcfg, 4096)]

    def test_bundled_trace_and_shapes_equal_reference(self):
        assert dataclasses.asdict(tbundled.ALEXNET_K80) == \
            dataclasses.asdict(jbundled.ALEXNET_K80)
        assert list(tbundled.BUNDLED_TRACES) == list(jbundled.BUNDLED_TRACES)

    def test_unknown_workloads_rejected_like_reference(self):
        for bad in ("cnn:vgg", "llm:gpt-5", "warp:x", "trace:/no/such.trace",
                    "llm:whisper-large"):
            with pytest.raises(ValueError, match="unknown workload"):
                tworkloads.resolve_workload(bad)
            with pytest.raises(ValueError, match="unknown workload"):
                jworkloads.resolve_workload(bad)

    @pytest.mark.parametrize("name", ["llm:whisper-tiny", "llm:llama-3.2-vision-90b"])
    def test_encdec_workloads_equal_reference(self, name):
        """The two encoder-fed archs (``C`` blocks; whisper's audio encoder)
        resolve, since their configs are ported, to the reference's table."""
        self._assert_tables_equal(tworkloads.resolve_workload(name),
                                  jworkloads.resolve_workload(name))


class TestGrids:
    @pytest.mark.parametrize("name", ["default_grid", "mixed_grid", "frontier_grid"])
    def test_expansion_and_numpy_engine_equal_reference(self, name):
        g, jg = getattr(tscen, name)(), getattr(jscen, name)()
        assert dataclasses.asdict(g) == dataclasses.asdict(jg)
        sc, jsc = g.expand(), jg.expand()
        assert [dataclasses.asdict(s) for s in sc[::97]] == \
            [dataclasses.asdict(s) for s in jsc[::97]]
        assert len(sc) == len(jsc)
        got = tbatched.grid_evaluator(g).run().table_slice(0, len(g))[0]
        want = jbatched.grid_evaluator(jg).run().table_slice(0, len(jg))[0]
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tolist() == want[k].tolist(), k

    def test_grid_from_spec_equals_reference(self):
        spec = {"grid": "frontier", "workloads": "alexnet,trace:alexnet-k80",
                "workers": [2, 8], "het": "none,het:1x0.5+3x1.0",
                "stragglers": "none,exp:0.5x16", "sync_k": "none,3",
                "faults": ["none", "fail:0.1@restart1.5x16"], "batch_per_gpu": 16}
        assert dataclasses.asdict(tscen.grid_from_spec(spec)) == \
            dataclasses.asdict(jscen.grid_from_spec(spec))
        for bad in ({"grid": "warp"}, {"policies": "warp"}, {"warp": 1},
                    {"workers": ""}, {"sync_k": "-1"}):
            with pytest.raises(ValueError):
                jscen.grid_from_spec(bad)
            with pytest.raises(ValueError):
                tscen.grid_from_spec(bad)


class TestPrefixMaxTwin:
    """The torch twin of ``non_overlapped_comm_batch`` against both reference
    forms.  The batch forms add the same terms in the same order, so they
    agree to a few ulps of the largest partial sum (``8 eps (sum t_b + sum
    t_c)``; on the CPU bit for bit).  The scalar loop accumulates the
    backward finish from layer L down, the batch forms ``total - prefix +
    t_b``: different roundings of sums of the same magnitude, so they agree
    to the same absolute bound, not relatively — a residual that is exactly
    0 in exact arithmetic can come out as one ulp of ``sum(t_b)`` in one
    form and 0 in the other."""

    #: An all-reduce that ends exactly as the backward does: layer 2's comm
    #: (4.675) starts when its backward ends (0.014 + 4.079) and ends at
    #: 8.768 = sum(t_b); the loop rounds 8.768 up, ``sum(t_b)`` (forward
    #: order) down to 8.767999999999999, so the loop gives 1.78e-15 and the
    #: batch forms 0 — beyond ``tests/test_batched.py``'s abs 1e-15.
    DISAGREE = ([4.675, 4.079, 0.014], [0.0, 4.675, 0.0])

    @staticmethod
    def _bound(t_b, t_c):
        return 8 * EPS * (np.sum(t_b) + np.sum(t_c))

    def _check(self, t_b, t_c):
        t_b, t_c = np.asarray(t_b), np.asarray(t_c)
        got = float(tanalytical.non_overlapped_comm_batch(_t(t_b[None]), _t(t_c[None]))[0])
        batch = float(janalytical.non_overlapped_comm_batch(t_b[None], t_c[None])[0])
        loop = janalytical.non_overlapped_comm(list(t_b), list(t_c))
        bound = self._bound(t_b, t_c)
        assert abs(got - batch) <= bound
        assert abs(got - loop) <= bound
        return got, batch, loop

    @settings(max_examples=200, deadline=None)
    @given(wfbp_layer_times())
    def test_torch_twin_matches_both_reference_forms(self, times):
        self._check(*times)

    def test_the_input_the_reference_forms_disagree_on(self):
        got, batch, loop = self._check(*self.DISAGREE)
        assert got == batch == 0.0
        assert loop == pytest.approx(1.7763568394002505e-15, abs=0)
        assert loop > 1e-15          # the reference test's abs tolerance

    def test_zero_comm_and_empty_layer_axis_give_exact_zero(self):
        z = tanalytical.non_overlapped_comm_batch(torch.ones(3, 4, dtype=torch.float64),
                                                  torch.zeros(3, 4, dtype=torch.float64))
        assert torch.equal(z, torch.zeros(3, dtype=torch.float64))
        assert torch.equal(xputil.max_or_zero(torch.zeros(2, 0, dtype=torch.float64), 1),
                           torch.zeros(2, dtype=torch.float64))
        np.testing.assert_array_equal(xputil.max_or_zero(np.zeros((2, 0)), 1), np.zeros(2))


@pytest.fixture(scope="module")
def measured_trace(tmp_path_factory):
    """A trace the port's measurement writes: ``python -m repro_torch.measure
    --smoke --device cpu`` for qwen1.5-4b."""
    out = tmp_path_factory.mktemp("measure_torch")
    r = subprocess.run([sys.executable, "-m", "repro_torch.measure", "--arch",
                        "qwen1.5-4b", "--smoke", "--device", "cpu", "--out-dir", str(out)],
                       env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return out / "qwen1.5-4b.trace"


class TestTorchProvider:
    GRID = dict(clusters=("k80-pcie-10gbe", "v100-nvlink-ib"), worker_counts=(2, 8, 32),
                policies=("cntk", "caffe-mpi", "bucketed-25mb", "priority"),
                collectives=("ring", "hierarchical"))

    def _assert_same_rows(self, ours, theirs):
        for k in tsweep.COLUMNS:
            if k == "workload":
                continue
            a, b = ours.columns[k], theirs.columns[k]
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12, err_msg=k)
            else:
                assert a.tolist() == b.tolist(), k

    def test_measured_trace_sweeps_like_the_reference_trace_provider(
            self, measured_trace, monkeypatch):
        theirs = jsweep.sweep(jscen.ScenarioGrid(
            workloads=(f"trace:{measured_trace}",), **self.GRID))
        assert theirs.n_simulated == 0 and theirs.n_timeline > 0
        by_path = tsweep.sweep(tscen.ScenarioGrid(
            workloads=(f"torch:{measured_trace}",), **self.GRID), device="cpu")
        self._assert_same_rows(by_path, theirs)
        assert (by_path.n_analytical, by_path.n_timeline, by_path.n_simulated) == \
            (theirs.n_analytical, theirs.n_timeline, 0)
        monkeypatch.setenv("REPRO_TORCH_MEASURE_DIR", str(measured_trace.parent))
        assert "torch:qwen1.5-4b" in tworkloads.known_workloads()
        by_stem = tsweep.sweep(tscen.ScenarioGrid(
            workloads=("torch:qwen1.5-4b",), **self.GRID), backend="numpy")
        self._assert_same_rows(by_stem, theirs)
        # both spellings resolve to one file, memoized once (by path + mtime)
        table = tworkloads.resolve_workload("torch:qwen1.5-4b")
        assert table is tworkloads.resolve_workload(f"torch:{measured_trace}")
        assert table.name == f"torch:{measured_trace}" and table.is_measured
        TestWorkloadTables._assert_tables_equal(
            table, jworkloads.resolve_workload(f"trace:{measured_trace}"),
            name_of=lambda n: n.replace("trace:", "torch:", 1))

    def test_cache_follows_the_file(self, measured_trace, tmp_path, monkeypatch):
        monkeypatch.setenv("REPRO_TORCH_MEASURE_DIR", str(tmp_path))
        with pytest.raises(ValueError, match="python -m repro_torch.measure"):
            tworkloads.resolve_workload("torch:qwen1.5-4b")
        path = tmp_path / "qwen1.5-4b.trace"
        text = measured_trace.read_text()
        path.write_text(text)
        first = tworkloads.resolve_workload("torch:qwen1.5-4b")
        assert tworkloads.resolve_workload("torch:qwen1.5-4b") is first
        path.write_text(text.replace("# batch: 2", "# batch: 4"))
        os.utime(path, ns=(1, os.stat(path).st_mtime_ns + 10**9))
        second = tworkloads.resolve_workload("torch:qwen1.5-4b")
        assert second is not first and second.batch_default == 4


class TestLastCopies:
    """The copies that no port path called until the framework-comparison
    twin: Eqs. (1) and (6), ``iteration_time``, the reduce-scatter /
    all-gather / all-to-all times, ``total_flops``,
    ``make_iteration_costs`` and the DAG's graph queries, each ``==`` the
    original on seeded inputs."""

    def _costs(self, rng):
        L = int(rng.integers(1, 12))
        return dict(t_f=list(rng.uniform(0, 1, L)), t_b=list(rng.uniform(0, 1, L)),
                    t_c=list(rng.uniform(0, 1, L) * (rng.uniform(size=L) < 0.6)),
                    t_io=float(rng.uniform(0, 3)), t_h2d=float(rng.uniform(0, 1)),
                    t_u=float(rng.uniform(0, 1)))

    @pytest.mark.parametrize("seed", range(3))
    def test_eq1_eq6_and_iteration_time_equal_reference(self, seed):
        rng = np.random.default_rng(100 + seed)
        for _ in range(20):
            kw, kw1 = self._costs(rng), self._costs(rng)
            tc, jc = tdag.IterationCosts(**kw), jdag.IterationCosts(**kw)
            assert tanalytical.eq1_sgd_iteration(tc) == janalytical.eq1_sgd_iteration(jc)
            n = int(rng.integers(1, 65))
            assert tanalytical.eq6_speedup(tdag.IterationCosts(**kw1), tc, n) == \
                janalytical.eq6_speedup(jdag.IterationCosts(**kw1), jc, n)
            for name, p in jpolicies.ALL_POLICIES.items():
                if janalytical.closed_form(jc, p) is None:
                    with pytest.raises(ValueError, match="no exact closed form"):
                        tanalytical.iteration_time(tc, name)
                    with pytest.raises(ValueError, match="no exact closed form"):
                        janalytical.iteration_time(jc, name)
                else:
                    assert tanalytical.iteration_time(tc, name) == \
                        janalytical.iteration_time(jc, name)

    def test_eq6_with_no_time_gives_the_worker_count(self):
        zero = dict(t_f=[0.0], t_b=[0.0], t_c=[0.0], t_io=0.0, t_h2d=0.0, t_u=0.0)
        assert tanalytical.eq6_speedup(tdag.IterationCosts(**zero),
                                       tdag.IterationCosts(**zero), 8) == \
            janalytical.eq6_speedup(jdag.IterationCosts(**zero),
                                    jdag.IterationCosts(**zero), 8) == 8.0

    @pytest.mark.parametrize("cluster", sorted(jhw.CLUSTERS))
    def test_collective_times_equal_reference(self, cluster):
        rng = np.random.default_rng(len(cluster))
        tcl, jcl = thw.CLUSTERS[cluster], jhw.CLUSTERS[cluster]
        for fn in ("reduce_scatter_time", "allgather_time", "alltoall_time"):
            for n in (None, 0, 1, 2, 3, 4, 8, 16, 64, 512):
                nbytes = float(rng.uniform(1.0, 1e9))
                assert getattr(tcl, fn)(nbytes, n) == getattr(jcl, fn)(nbytes, n), (fn, n)

    @pytest.mark.parametrize("name", ["alexnet", "googlenet", "resnet50"])
    def test_total_flops_and_make_iteration_costs_equal_reference(self, name):
        tlayers = getattr(tcostmodel, f"{name}_layers")()
        jlayers = getattr(jcostmodel, f"{name}_layers")()
        assert tcostmodel.total_flops(tlayers) == jcostmodel.total_flops(jlayers)
        rng = np.random.default_rng(7)
        for cluster in sorted(jhw.CLUSTERS):
            for collective in jhw.COLLECTIVE_ALGORITHMS:
                n, batch = int(rng.integers(1, 33)), int(rng.integers(1, 129))
                kw = dict(batch_per_gpu=batch, n_workers=n, collective=collective,
                          decode_seconds_per_byte=float(rng.uniform(0, 1e-8)))
                for extra in ({}, {"bytes_per_sample": 3e5, "bwd_fwd_ratio": 2.5}):
                    got = tcostmodel.make_iteration_costs(tlayers, thw.CLUSTERS[cluster],
                                                          **kw, **extra)
                    want = jcostmodel.make_iteration_costs(jlayers, jhw.CLUSTERS[cluster],
                                                           **kw, **extra)
                    assert dataclasses.asdict(got) == dataclasses.asdict(want)
                got = tcostmodel.make_iteration_costs(f"cnn:{name}", thw.CLUSTERS[cluster],
                                                      **kw)
                want = jcostmodel.make_iteration_costs(f"cnn:{name}", jhw.CLUSTERS[cluster],
                                                       **kw)
                for f in dataclasses.fields(want):
                    _equal(getattr(got, f.name), getattr(want, f.name))

    @pytest.mark.parametrize("policy", ["cntk", "caffe-mpi", "bucketed-25mb", "priority"])
    def test_dag_queries_equal_reference(self, policy):
        rng = np.random.default_rng(3)
        kw = self._costs(rng)
        t = tdag.build_ssgd_dag(tdag.IterationCosts(**kw), 3,
                                tpolicies.ALL_POLICIES[policy], n_iterations=3)
        j = jdag.build_ssgd_dag(jdag.IterationCosts(**kw), 3,
                                jpolicies.ALL_POLICIES[policy], n_iterations=3)
        assert len(t) == len(j) > 0
        assert t.sources() == j.sources() and t.sinks() == j.sinks()
        assert t.topo_order() == j.topo_order()
        assert t.critical_path() == j.critical_path()
        assert t.total_work() == j.total_work()

    def test_topo_order_refuses_a_cycle(self):
        for mod in (tdag, jdag):
            g = mod.DAG()
            a = g.add_task("fwd", mod.TaskKind.COMPUTE, 1.0, "gpu0")
            b = g.add_task("bwd", mod.TaskKind.COMPUTE, 1.0, "gpu0")
            g.add_edge(a, b)
            g.add_edge(b, a)
            with pytest.raises(ValueError, match="cycle"):
                g.topo_order()


class TestFrameworkComparisonTwin:
    def test_rows_and_printout_equal_reference(self, capsys):
        """The twin's 150 rows (torch backend, ``device="cpu"``) against the
        reference's ``sweep(grid)``: labels exact, numbers within 1e-6
        relative / 1e-12 absolute (``tests/test_torch_sweep.py``); its
        printed tables and findings line for line, but the timing line."""
        import importlib.util

        from repro_torch.examples import framework_comparison as twin

        got = twin.run("cpu")
        port_out = capsys.readouterr().out.splitlines()
        spec = importlib.util.spec_from_file_location(
            "reference_framework_comparison", ROOT / "examples" / "framework_comparison.py")
        ref = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ref)
        ref.main()
        ref_out = capsys.readouterr().out.splitlines()
        want = jsweep.sweep(jscen.ScenarioGrid(
            workloads=ref.WORKLOADS, clusters=ref.CLUSTERS,
            worker_counts=(1, 2, 4, 8, 16), policies=ref.POLICIES))
        assert len(got) == len(want) == 150
        assert got.backend == "torch"
        assert (got.n_analytical, got.n_timeline, got.n_simulated) == \
            (want.n_analytical, want.n_timeline, want.n_simulated)
        assert set(got.columns) == set(want.columns)
        for key, col in want.columns.items():
            a, b = np.asarray(got.columns[key]), np.asarray(col)
            if b.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12, err_msg=key)
            else:
                assert a.tolist() == b.tolist(), key
        assert port_out[0].startswith("swept 150 scenarios in ")
        assert port_out[1:] == ref_out[1:]
