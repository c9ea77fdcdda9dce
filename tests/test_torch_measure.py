"""The port's measurement loop and its copies of the reference's pure
functions, on the CPU.

* The copies (``segment_from_depths``, ``fit_alpha_beta``,
  ``comm_scale_from_fit``, the trace writer) equal the originals on
  random inputs, exactly: they are the same float64 arithmetic.
* A smoke measurement of the first four measured archs and of
  qwen2-moe-a2.7b and grok-1-314b (the MoE MLP, its float32 router among
  the bytes; grok-1-314b is measured only reduced)
  (``python -m repro_torch.measure --smoke --device cpu``, the reference's
  ``SMOKE_GEOMETRY``, 2 gloo ranks) writes a trace
  that ``repro.traces.format.read_trace`` reads and that the unchanged
  sweep evaluates as ``trace:<path>`` through the closed form
  (``caffe-mpi``) and the bucket timeline (``bucketed-25mb``).
* The port's Fig. 4 loop (``repro_torch.measure.model_vs_measured``)
  predicts each policy of that run exactly as
  ``benchmarks.bench_model_vs_measured.predict_policies`` does.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.scenarios import Scenario
from repro.core.sweep import evaluate_scenario
from repro.measure import calibrate as jcal
from repro.measure import harness as jharness
from repro.measure import run as jrun
from repro.traces import format as jformat
from repro_torch.configs import get_config as torch_get_config
from repro_torch.device import resolve_device
from repro_torch.kernels import all_launches
from repro_torch.measure import calibrate as tcal
from repro_torch.measure import harness as tharness
from repro_torch.measure import model_vs_measured as tmvm
from repro_torch.measure import run as trun
from repro_torch.traces import format as tformat

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCH = "qwen1.5-4b"
ARCHS = ("qwen1.5-4b", "recurrentgemma-2b", "rwkv6-1.6b", "gemma3-1b",
         "internlm2-20b", "qwen1.5-32b", "qwen2-moe-a2.7b", "grok-1-314b")
#: the archs of the CPU smoke measurement
SMOKE_ARCHS = ("qwen1.5-4b", "recurrentgemma-2b", "rwkv6-1.6b", "gemma3-1b",
               "qwen2-moe-a2.7b", "grok-1-314b")


class TestCopies:
    @pytest.mark.parametrize("seed", range(5))
    def test_segment_from_depths_equals_reference(self, seed):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(2, 5))
        units = sorted(rng.choice(np.arange(1, 20), n, replace=False).tolist())
        fwd = rng.uniform(-0.01, 1.0, n).tolist()
        full = rng.uniform(-0.01, 3.0, n).tolist()
        assert dataclasses.asdict(tharness.segment_from_depths(units, fwd, full)) == \
            dataclasses.asdict(jharness.segment_from_depths(units, fwd, full))

    def test_segment_from_depths_rejects_like_reference(self):
        for args in (([2], [1.0], [2.0]), ([2, 2], [1.0, 1.0], [2.0, 2.0])):
            with pytest.raises(ValueError):
                jharness.segment_from_depths(*args)
            with pytest.raises(ValueError):
                tharness.segment_from_depths(*args)

    @pytest.mark.parametrize("seed", range(5))
    def test_fit_alpha_beta_equals_reference(self, seed):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(0, 6))
        sizes = rng.choice([1e3, 4e5, 2e6, 3e7, 1e9], n).tolist()
        samples = [(b, float(rng.uniform(-1e-4, 0.5))) for b in sizes]
        got, want = tcal.fit_alpha_beta(samples), jcal.fit_alpha_beta(samples)
        assert got == want
        for total in (0.0, 1e3, 5e8):
            assert tcal.comm_scale_from_fit(*got)(total, 0.0) == \
                jcal.comm_scale_from_fit(*want)(total, 0.0)

    def test_fit_alpha_beta_degenerate_cases(self):
        for samples in ([], [(1e6, 0.01)], [(1e6, 0.01), (1e6, 0.02)],
                        [(1e6, 0.02), (2e6, 0.01)]):
            assert tcal.fit_alpha_beta(samples) == jcal.fit_alpha_beta(samples)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_depth_variants_equal_reference(self, arch):
        for arch_cfg in (dict(num_layers=2), dict(num_layers=3), dict(num_layers=5)):
            jcfg = jax_get_config(arch).reduced(**arch_cfg)
            tcfg = torch_get_config(arch).reduced(**arch_cfg)
            assert tharness._default_depths(tcfg) == jharness._default_depths(jcfg)
            for u in (1, 3):
                j, t = jharness._depth_variant(jcfg, u), tharness._depth_variant(tcfg, u)
                assert (t.name, t.num_layers, t.num_units) == (j.name, j.num_layers, j.num_units)

    def test_trace_writer_is_byte_identical(self, tmp_path):
        rng = np.random.default_rng(0)
        rows = [(i, f"l{i}", *rng.uniform(0, 1e4, 3).tolist(), float(rng.integers(0, 1e9)))
                for i in range(4)]
        for batch, bps in ((0, 0.0), (2, 256.0)):
            jt = jformat.Trace("net", "clu", (tuple(jformat.LayerRecord(*r) for r in rows),) * 2,
                               batch_per_gpu=batch, bytes_per_sample=bps)
            tt = tformat.Trace("net", "clu", (tuple(tformat.LayerRecord(*r) for r in rows),) * 2,
                               batch_per_gpu=batch, bytes_per_sample=bps)
            jformat.write_trace(jt, tmp_path / "j.trace")
            tformat.write_trace(tt, tmp_path / "t.trace")
            assert (tmp_path / "t.trace").read_bytes() == (tmp_path / "j.trace").read_bytes()
            assert jformat.read_trace(tmp_path / "t.trace") == jt

    def test_trace_rejects_ragged_like_reference(self):
        a = (tformat.LayerRecord(0, "a", 1, 1, 1, 1),)
        with pytest.raises(ValueError, match="ragged"):
            tformat.Trace("n", "c", (a, a + a))
        with pytest.raises(ValueError):
            tformat.Trace("n", "c", ())


class TestCalibrate:
    def test_metric_bytes_and_cluster_name(self):
        assert tcal.METRIC_COLLECTIVE_BYTES == jcal.METRIC_COLLECTIVE_BYTES
        assert tcal.cluster_name("cuda", "gloo", 2) == "torch-cuda-gloo-x2"
        assert tcal.cluster_name("cpu", "gloo", 2) == "torch-cpu-gloo-x2"

    @pytest.mark.parametrize("arch,depth,unit_params,rest_params", [
        ("qwen1.5-4b", 2, 79.3e6, 777.9e6),
        ("recurrentgemma-2b", 3, 256.9e6, 655.4e6),
        ("rwkv6-1.6b", 2, 58.76e6, 268.44e6),
        ("gemma3-1b", 6, 161.05e6, 301.99e6),
        ("internlm2-20b", 2, 390.09e6, 1137.19e6),
        ("qwen1.5-32b", 1, 525.63e6, 1557.15e6),
        ("qwen2-moe-a2.7b", 2, 570.69e6, 622.33e6),
        ("grok-1-314b", 1, 4920.04e6, 1610.63e6),
    ])
    def test_full_width_payloads(self, arch, depth, unit_params, rest_params):
        """At the published widths: a qwen1.5-4b unit is 79.3 M parameters
        (158.6 MB in bf16), embedding + untied head 777.9 M; a
        recurrentgemma-2b RRL unit is 256.9 M (two RG-LRU blocks of 91.8 M,
        a local-attention block of 73.4 M), the tied embedding 655.4 M; a
        rwkv6-1.6b W unit is 58.7 M bf16 parameters and 14 336 float32 ones
        (``w_bias``, ``u``, ``ln_scale``, the layer norms), 117.5 MB, counted
        here in bf16 equivalents; embedding + untied head 268.4 M; a
        gemma3-1b LLLLLG unit is 161.05 M (six blocks of 26.84 M: 2.95 M of
        attention with one kv head, 23.89 M of MLP), the tied embedding of
        262 144 x 1152 302.0 M; an internlm2-20b unit 390.1 M (88.1 M of
        attention with 8 kv heads, 302.0 M of MLP), embedding + untied head
        of 92 544 x 6144 1137.2 M; a qwen1.5-32b unit 525.6 M, embedding +
        head 1557.1 M; a qwen2-moe-a2.7b unit 570.7 M bf16 equivalents (60
        experts of 8.65 M, 519.0 M; the shared experts 34.6 M; the float32
        router of 2048 x 60), embedding + head 622.3 M; a grok-1-314b unit
        4920.0 M (8 experts of 603.98 M), embedding + head 1610.6 M."""
        cfg = dataclasses.replace(torch_get_config(arch), num_layers=depth)
        unit, rest = tcal.grad_payload_bytes(cfg)
        assert unit / 2 == pytest.approx(unit_params, rel=1e-3)
        assert rest / 2 == pytest.approx(rest_params, rel=1e-3)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_payloads_and_expected_bytes_equal_reference_at_full_width(self, arch):
        """At the published widths and the measured depth (qwen1.5-32b at
        1 layer): the payloads and each policy's expected all-reduce bytes
        equal the reference's, each leaf priced in its own dtype (the MoE
        router in float32) or, under ``bucketed``, in float32."""
        depth = 1 if arch == "qwen1.5-32b" else trun.default_num_layers(torch_get_config(arch))
        tcfg = dataclasses.replace(torch_get_config(arch), num_layers=depth)
        jcfg = dataclasses.replace(jax_get_config(arch), num_layers=depth)
        assert tcal.grad_payload_bytes(tcfg) == jcal.grad_payload_bytes(jcfg)
        for pol in ("at_end", "wfbp", "bucketed"):
            assert tcal.expected_collective_bytes(tcfg, pol) == \
                jcal.expected_collective_bytes(jcfg, pol)


class TestRunner:
    def test_smoke_geometry_is_the_reference_preset(self):
        assert dataclasses.asdict(trun.SMOKE_GEOMETRY) == dataclasses.asdict(jrun.SMOKE_GEOMETRY)

    def test_a_cpu_rank_runs_one_thread(self, tmp_path):
        """A CPU rank computes on one thread: with several, the smoke
        measurement's small operators stall at each parallel region's barrier
        when other processes hold the cores, and a few smoke runs side by side
        outlast the smoke fixture's timeout."""
        seen = {}
        before = torch.get_num_threads()
        try:
            trun._rank_entry(0, 1, str(tmp_path / "rendezvous"), "cpu",
                             lambda rank, dev: seen.update(threads=torch.get_num_threads(),
                                                           dev=dev), ())
        finally:
            torch.set_num_threads(before)
        assert seen == {"threads": 1, "dev": torch.device("cpu")}

    @pytest.mark.parametrize("arch,widths", [
        ("qwen1.5-4b", (2560, 20, 6912, 151_936)),
        ("recurrentgemma-2b", (2560, 10, 7680, 256_000)),
        ("rwkv6-1.6b", (2048, 32, 7168, 65_536)),
        ("gemma3-1b", (1152, 4, 6912, 262_144)),
        ("internlm2-20b", (6144, 48, 16384, 92_544)),
        ("qwen1.5-32b", (5120, 40, 27392, 152_064)),
        ("qwen2-moe-a2.7b", (2048, 16, 1408, 151_936)),
        ("grok-1-314b", (6144, 48, 32768, 131_072)),
    ])
    def test_config_for_published_width_and_reduced(self, arch, widths):
        full = trun.config_for(arch, trun.Geometry(num_layers=2))
        assert (full.d_model, full.num_heads, full.d_ff, full.vocab_size, full.num_layers) == \
            (*widths, 2)
        assert full.dtype == torch.bfloat16
        small = trun.config_for(arch, trun.SMOKE_GEOMETRY)
        assert (small.d_model, small.num_layers, small.dtype) == (128, 4, torch.float32)

    @pytest.mark.parametrize("arch,layers,units,depths", [
        ("qwen1.5-4b", 2, 2, (2, 4)),
        ("recurrentgemma-2b", 3, 1, (1, 2)),
        ("rwkv6-1.6b", 2, 2, (2, 4)),
        ("gemma3-1b", 6, 1, (1, 2)),
        ("internlm2-20b", 2, 2, (2, 4)),
        ("qwen2-moe-a2.7b", 2, 2, (2, 4)),
    ])
    def test_default_num_layers_is_one_pattern_and_at_least_two(self, arch, layers, units,
                                                                depths):
        """``--num-layers`` left out: qwen1.5-4b (``G``) and rwkv6-1.6b
        (``W``) 2 layers, 2 units; recurrentgemma-2b (``RRL``) 3 layers, one
        unit, segmented at 1 and 2 units (3 and 6 layers); gemma3-1b
        (``LLLLLG``) 6 layers, one unit, segmented at 6 and 12 layers."""
        assert trun.Geometry().num_layers is None
        cfg = trun.config_for(arch, trun.Geometry())
        assert (cfg.num_layers, cfg.num_units, cfg.remainder_pattern) == (layers, units, "")
        assert tharness._default_depths(cfg) == depths
        assert [tharness._depth_variant(cfg, u).num_layers for u in depths] == \
            [u * len(cfg.layer_pattern) for u in depths]

    def test_cli_parses_geometry_flags(self):
        args = trun.build_parser().parse_args(
            ["--arch", ARCH, "--seq-len", "64", "--devices", "3", "--device", "cpu"])
        assert (args.seq_len, args.n_devices, args.device, args.num_layers) == \
            (64, 3, "cpu", None)
        with pytest.raises(SystemExit):   # not a decoder-only LM
            trun.build_parser().parse_args(["--arch", "whisper-tiny"])
        for arch in ("recurrentgemma-2b", "gemma3-1b", "internlm2-20b", "qwen2-moe-a2.7b"):
            args = trun.build_parser().parse_args(["--arch", arch])
            assert args.arch == arch and args.num_layers is None
        args = trun.build_parser().parse_args(["--arch", "qwen1.5-32b", "--num-layers", "1"])
        assert args.num_layers == 1
        assert set(trun.MEASURABLE_ARCHS) == set(jrun.MEASURABLE_ARCHS)

    def test_qwen32_at_one_layer_segments_at_one_and_two(self):
        """qwen1.5-32b's measured cut: ``--num-layers 1``, one unit, the
        segments at 1 and 2 layers."""
        cfg = trun.config_for("qwen1.5-32b", trun.Geometry(num_layers=1))
        assert (cfg.num_layers, cfg.num_units, cfg.remainder_pattern) == (1, 1, "")
        assert tharness._default_depths(cfg) == (1, 2)
        assert [tharness._depth_variant(cfg, u).num_layers for u in (1, 2)] == [1, 2]

    def test_cuda_is_the_default_and_never_falls_back(self):
        if torch.cuda.is_available():
            pytest.skip("checks the behaviour without a GPU")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trun.run_measurement(ARCH, "unused", trun.SMOKE_GEOMETRY)
        assert resolve_device("cpu").type == "cpu"


@pytest.fixture(scope="module", params=SMOKE_ARCHS)
def smoke_run(request, tmp_path_factory):
    """(output directory, JSON document, arch) of one smoke measurement."""
    arch = request.param
    out = tmp_path_factory.mktemp("measure")
    r = subprocess.run([sys.executable, "-m", "repro_torch.measure", "--arch", arch,
                        "--smoke", "--device", "cpu", "--out-dir", str(out)],
                       env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return out, json.loads((out / f"{arch}.json").read_text()), arch


class TestSmokeMeasurement:
    def test_trace_reads_back_with_the_layers_and_payloads(self, smoke_run):
        """qwen1.5-4b's and rwkv6-1.6b's 4 smoke layers are 4 units;
        recurrentgemma-2b's are one RRL unit and a remaining R block, counted
        with the rest; gemma3-1b's reduced pattern is ``LG``, 2 units;
        qwen2-moe-a2.7b's and grok-1-314b's are 4 ``G`` units with the MoE
        MLP.  The per-layer times are what the run determines, not
        CPU timings judged by size: each unit row holds the JSON's unit
        segment, the first row the rest's, times 1e6 (a segment is a clamped
        slope of two noisy timings and may be 0 on a shared CPU)."""
        out, doc, arch = smoke_run
        trace = jformat.read_trace(out / f"{arch}.trace")
        cfg = trun.config_for(arch, trun.SMOKE_GEOMETRY)
        unit, rest = tcal.grad_payload_bytes(cfg)
        n = {"qwen1.5-4b": 4, "recurrentgemma-2b": 1, "rwkv6-1.6b": 4, "gemma3-1b": 2,
             "qwen2-moe-a2.7b": 4, "grok-1-314b": 4}[arch]
        assert cfg.num_units == n == doc["num_units"]
        assert trace.cluster == "torch-cpu-gloo-x2"
        assert trace.batch_per_gpu == 2 and trace.bytes_per_sample == 8.0 * 32
        recs = trace.iterations[0]
        assert [r.name for r in recs] == ["embed_head"] + [f"unit{i}" for i in range(n)]
        assert [r.size_bytes for r in recs] == [rest] + [unit] * n
        assert all(r.forward_us >= 0 and r.backward_us >= 0 and r.comm_us > 0 for r in recs)
        seg = doc["segments"]
        assert (recs[0].forward_us, recs[0].backward_us) == \
            (seg["rest_fwd_s"] * 1e6, seg["rest_bwd_s"] * 1e6)
        for r in recs[1:]:
            assert (r.forward_us, r.backward_us) == \
                (seg["unit_fwd_s"] * 1e6, seg["unit_bwd_s"] * 1e6)

    def test_json_records_the_run(self, smoke_run):
        _, doc, arch = smoke_run
        assert doc["device"] == "cpu" and doc["n_devices"] == 2
        assert set(doc["policy_times_s"]) == {"at_end", "wfbp", "bucketed"}
        assert all(t > 0 for t in doc["policy_times_s"].values())
        losses = list(doc["policy_losses"].values())
        assert len(losses) == 3 and all(np.isfinite(losses))
        assert max(losses) - min(losses) < 1e-4 * max(losses)
        assert doc["t_update_s"] > 0
        jcfg = jax_get_config(arch).reduced(num_layers=4, d_model=128, num_heads=4,
                                            d_ff=256, vocab_size=512)
        for pol, chk in doc["bytes_crosscheck"].items():
            assert chk["counted_bytes"] == chk["expected_bytes"] == \
                jcal.expected_collective_bytes(jcfg, pol)
        # on the CPU the wrappers run their plain versions and count nothing
        assert doc["kernel_launches"] == {name: 0 for name in all_launches()}
        assert set(doc["kernel_launches"]) == {"flash_fwd", "flash_bwd_delta", "flash_bwd_dq",
                                               "flash_bwd_dkdv", "rglru_fwd", "rglru_bwd",
                                               "wkv6_fwd", "wkv6_bwd"}
        lat, bw = doc["allreduce_fit"].values()
        assert lat >= 0 and bw > 0

    def test_policies_leave_the_same_momentum(self, smoke_run):
        """The f32 momentum after the timed steps sums the synchronized
        gradients: every policy leaves the same per-leaf norms (float32 on
        the CPU, reduced in different orders)."""
        _, doc, arch = smoke_run
        norms = doc["policy_momentum_norms"]
        assert set(norms) == {"at_end", "wfbp", "bucketed"}
        leaves = list(norms["at_end"])
        mixer = {"qwen1.5-4b": "units/b0/attn/wq", "recurrentgemma-2b": "units/b0/rglru/lam",
                 "rwkv6-1.6b": "units/b0/time_mix/u", "gemma3-1b": "units/b0/attn/wq",
                 "qwen2-moe-a2.7b": "units/b0/moe/router",
                 "grok-1-314b": "units/b0/moe/router"}
        assert "embedding" in leaves and mixer[arch] in leaves
        for leaf in leaves:
            vals = [norms[pol][leaf] for pol in norms]
            assert min(vals) > 0 and max(vals) - min(vals) <= 1e-5 * max(vals), leaf

    @pytest.mark.parametrize("policy,method", [("caffe-mpi", "analytical"),
                                               ("bucketed-25mb", "timeline")])
    def test_sweep_evaluates_the_trace(self, smoke_run, policy, method):
        out, _, arch = smoke_run
        row = evaluate_scenario(Scenario(f"trace:{out / f'{arch}.trace'}",
                                         "k80-pcie-10gbe", 2, policy))
        assert row["method"] == method
        assert np.isfinite(row["iteration_time_s"]) and row["iteration_time_s"] > 0

    def test_sweep_cli_takes_the_trace(self, smoke_run, capsys):
        from repro.launch.sweep import main

        out, _, arch = smoke_run
        rc = main(["--workloads", f"trace:{out / f'{arch}.trace'}", "--clusters",
                   "k80-pcie-10gbe", "--workers", "2,4", "--policies",
                   "caffe-mpi,bucketed-25mb"])
        assert rc == 0
        assert "trace:" in capsys.readouterr().out


class TestModelVsMeasured:
    """The paper's Fig. 4 loop on the smoke run: the trace, the measured
    ``t_u`` and the alpha-beta fit go through the port's copy of the DAG
    model, as ``benchmarks/bench_model_vs_measured.py`` sends the
    reference's through ``repro.core``."""

    def test_trace_reads_like_the_reference(self, smoke_run):
        out, doc, arch = smoke_run
        path = out / f"{arch}.trace"
        j, t = jformat.read_trace(path), tformat.read_trace(path)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert dataclasses.asdict(t.to_iteration_costs(t_u=doc["t_update_s"])) == \
            dataclasses.asdict(j.to_iteration_costs(t_u=doc["t_update_s"]))

    def test_predict_policies_equals_the_bench(self, smoke_run):
        from benchmarks.bench_model_vs_measured import predict_policies

        out, doc, arch = smoke_run
        got = tmvm.predict_policies(doc, out / f"{arch}.trace")
        assert got == predict_policies(doc, str(out / f"{arch}.trace"))
        assert set(got) == {"at_end", "wfbp", "bucketed"}
        errors = tmvm.model_error(doc, out / f"{arch}.trace")
        for pol, row in errors.items():
            assert row["predicted_s"] == got[pol] > 0
            assert row["measured_s"] == doc["policy_times_s"][pol]
            assert row["error_pct"] == \
                abs(got[pol] - row["measured_s"]) / row["measured_s"] * 100

    def test_cli_writes_finite_errors(self, smoke_run, tmp_path, capsys):
        out, _, arch = smoke_run
        dest = tmp_path / "fig4.json"
        assert tmvm.main(["--out-dir", str(out), "--archs", arch, "--json", str(dest)]) == 0
        doc = json.loads(dest.read_text())
        rows = doc["archs"][arch]["policies"]
        assert set(rows) == {"at_end", "wfbp", "bucketed"}
        for row in rows.values():
            assert all(np.isfinite(v) for v in row.values()) and row["predicted_s"] > 0
        assert doc["max_error_pct"] == max(r["error_pct"] for r in rows.values())
        assert f"{arch:18s} at_end" in capsys.readouterr().out
        # a ceiling below the largest error fails the run
        assert tmvm.main(["--out-dir", str(out), "--archs", arch,
                          "--assert-error-ceiling", "-1"]) == 1
