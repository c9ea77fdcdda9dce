"""The port's roofline report against a hand computation, on the CPU.

``repro_torch.launch.roofline`` is the reference's report priced against
the H100's data-sheet peaks (``repro_torch.kernels.cost``): its terms on a
synthetic record equal the hand computation, its tables render the dry
run's own records, and no ``V5E_*`` constant is used anywhere in the port.
"""
import json
import re
from pathlib import Path

import pytest
import torch

from repro.launch import roofline as jroofline
from repro_torch.kernels import cost
from repro_torch.launch import dryrun, roofline

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _record(mesh="dp8", n=8, flops=4.0e18, hbm=2.0e14, model=3.0e18, coll=9.0e11,
            shape="train_4k", arch="qwen1.5-4b"):
    return {"arch": arch, "shape": shape, "mesh": mesh, "n_devices": n, "status": "ok",
            "lower_s": 1.25, "memory": {"temp_bytes": 3e9, "argument_bytes": 5e9},
            "collectives": {"total_bytes": coll, "total_count": 7},
            "analytic": {"flops": flops, "hbm_bytes": hbm, "model_flops": model}}


class TestTerms:
    def test_terms_equal_a_hand_computation(self):
        t = roofline.terms(_record())
        compute = 4.0e18 / (8 * 989e12)
        memory = 2.0e14 / (8 * 3.35e12)
        collective = 9.0e11 / 450e9
        assert t["compute"] == pytest.approx(compute, rel=1e-15)
        assert t["memory"] == pytest.approx(memory, rel=1e-15)
        assert t["collective"] == pytest.approx(collective, rel=1e-15)
        assert t["dominant"] == "compute" and t["bound"] == t["compute"]
        assert t["mfu"] == pytest.approx(3.0e18 / (8 * 989e12) / compute, rel=1e-15)
        assert t["useful"] == pytest.approx(0.75, rel=1e-15)

    def test_the_dominant_term_is_the_largest(self):
        assert roofline.terms(_record(coll=1e15))["dominant"] == "collective"
        assert roofline.terms(_record(hbm=1e18))["dominant"] == "memory"
        no_flops = roofline.terms(_record(flops=0.0, model=0.0))
        assert no_flops["useful"] == 0.0

    def test_constants_are_the_h100_data_sheet_peaks(self):
        assert roofline.PEAK_FLOPS_BF16 == 989e12 == cost.PEAK_FLOPS[torch.bfloat16]
        assert cost.PEAK_BYTES_PER_S == 3.35e12 and cost.NVLINK_BYTES_PER_S == 450e9
        assert roofline.SHAPE_ORDER == jroofline.SHAPE_ORDER

    def test_no_v5e_constant_in_the_port(self):
        # the reference's V5E_* peaks (``TPU_V5E_POD``, a sweep cluster of the
        # copied ``core/hardware.py``, is not one)
        hits = [str(p) for p in SRC.rglob("*.py") if re.search(r"\bV5E_", p.read_text())]
        assert hits == []


class TestTables:
    def test_tables_and_pick_from_records(self, tmp_path):
        recs = [_record(), _record(shape="decode_32k", coll=0.0, flops=1e15, model=1e15),
                _record(mesh="dp1", n=1, coll=0.0, arch="rwkv6-1.6b")]
        for i, r in enumerate(recs + [{"status": "error", "arch": "x"}]):
            (tmp_path / f"r{i}.json").write_text(json.dumps(r))
        loaded = roofline.load(tmp_path)
        assert len(loaded) == 3 and all("_terms" in r for r in loaded)
        table = roofline.roofline_table(loaded, "dp8")
        assert table.count("\n") == 3 and "rwkv6-1.6b" not in table
        assert "| qwen1.5-4b | train_4k |" in table and "**compute**" in table
        dry = roofline.dryrun_table(loaded)
        assert dry.count("\n") == 4 and "| 3.00 | 5.00 | 900.00 | 7 | 0.000 |" in dry
        worst, most_coll = roofline.pick_hillclimb(loaded, "dp8")
        assert worst["shape"] == "train_4k" and most_coll["shape"] == "train_4k"

    def test_main_renders_the_dry_runs_records(self, tmp_path, capsys):
        for shape in ("decode_32k", "long_500k"):
            rec = dryrun.dryrun_one("rwkv6-1.6b", shape, num_layers=1)
            (tmp_path / f"rwkv6-1.6b__{shape}__dp1.json").write_text(json.dumps(rec))
        out = tmp_path / "roofline.md"
        roofline.main(["--results-dir", str(tmp_path), "--write", "--out", str(out)])
        text = out.read_text()
        assert "# Roofline (dp1: 1 x NVIDIA H100 80GB HBM3, 700 W data-sheet peaks" in text
        assert text.count("| rwkv6-1.6b |") == 4
        assert "**memory**" in text
