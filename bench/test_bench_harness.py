"""The harness finds every piece of a cell by name, runs a cell's loop on the
CPU at tiny widths through the program's plain path, reduces a trace, and
loads nothing of JAX."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY = {"internlm2-20b": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                              d_ff=96, vocab_size=256),
        "rwkv6-1.6b": dict(num_layers=2, d_model=128, num_heads=2, d_ff=160, vocab_size=256)}
#: limits for the tiny widths (the cells' own are set at their sizes)
TINY_LIMITS = {"loss": 3e-3, "grad": 8e-3, "change": 1e-2}


def tiny_spec(cell):
    spec = harness.load_spec(cell, ROOT)
    spec["config"].update(TINY[spec["config"]["name"]])
    spec["traffic"].update(rows=2, seq_len=32, profile_steps=2)
    spec["limits"] = dict(TINY_LIMITS)
    return spec


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_pieces_by_name(cell):
    spec = harness.load_spec(cell, ROOT)
    assert spec["config"]["name"] == spec["workload"]["config"]
    assert {"rows", "seq_len", "lr", "momentum", "check_steps"} <= set(spec["traffic"])
    assert set(spec["limits"]) == {"loss", "grad", "change"}
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    assert spec["per_layer"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(m["name"], ROOT))
    assert hasattr(harness.family(spec["config"]), "row_loss")


def test_every_metric_has_a_reader_and_every_config_a_family():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert (ROOT / "bench" / "reference" / f"{conf['family']}.py").exists()
        assert set(c["reduced"]) <= set(conf)


def test_a_traced_cell_runs_on_the_cpu():
    cell = BENCH["workloads"][0]["name"]
    result, lines = harness.run(tiny_spec(cell), 2**31 + 7, 0.2, True, device="cpu")
    assert result["correct"], lines
    assert list(result)[-1] == "checks"
    host = {"data_wait_ms", "fwd_bwd_ms", "update_ms"}
    assert host <= set(result["metrics"])
    # no device metric is read from a CPU run
    assert not {"flash_roofline", "wkv6_roofline", "step_mfu_pct", "device_idle_pct"} & \
        set(result["metrics"])
    assert result["device"]["platform"] == "cpu"


def test_every_reader_reads_a_gpu_record():
    c = json.loads((ROOT / "bench/configs/internlm2-20b.json").read_text())
    t = json.loads((ROOT / "bench/traffic/train.b3.s4096.json").read_text())
    record = {"config": c, "traffic": t, "trace": True, "platform": "gpu",
              "window": {"steps": 20, "seconds": 30.0, "tokens": 20 * 12288},
              "setup_s": 20.0, "peak_bytes": 60 * 2**30,
              "spans": {"data_wait": [1e-3], "fwd_bwd": [1.2], "update": [0.05]},
              "profile": {"steps": 3, "wall_s": 4.5, "busy_s": 4.4,
                          "kernels": {"flash_fwd_mma_kernel": [24, 0.5],
                                      "wkv6_fwd_out_kernel": [24, 0.2], "nvjet": [99, 2.0]},
                          "launches": {"flash_fwd": 24, "flash_bwd_delta": 24,
                                       "flash_bwd_dq": 24, "flash_bwd_dkdv": 24,
                                       "wkv6_fwd": 24, "wkv6_bwd": 24}}}
    for path in sorted((ROOT / "bench" / "metrics").glob("*.py")):
        value = harness.reader(path.stem, ROOT)(record)
        assert isinstance(value, float) and value > 0, path.stem


def test_trace_reduction_names_gaps_by_span():
    us = 1e6
    events = [("bench.step", False, 0.0, 10.0 * us),
              ("bench.data_wait", False, 0.0, 1.0 * us),
              ("bench.fwd_bwd", False, 1.0 * us, 9.0 * us),
              ("bench.fwd_bwd", True, 1.0 * us, 9.0 * us),      # the span's device copy
              ("gemm", True, 1.5 * us, 4.0 * us), ("gemm", True, 3.0 * us, 8.0 * us),
              ("add", True, 9.5 * us, 10.0 * us)]
    out = harness.reduce_trace(events, 1)
    assert out["wall_s"] == 10.0 and out["busy_s"] == 7.0
    assert out["kernels"] == {"gemm": [2, 7.5], "add": [1, 0.5]}
    assert out["idle_gaps"] == [("data_wait", 1.5), ("fwd_bwd", 1.5)]


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from bench import harness, calibrate\n"
            "import repro_torch.comm.ddp, repro_torch.data.pipeline, repro_torch.optim.sgd\n"
            "import repro_torch.launch.steps, repro_torch.kernels\n"
            "print(harness.loaded_forbidden())" % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
