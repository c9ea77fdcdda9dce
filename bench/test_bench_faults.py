"""``correct`` comes out false when the timed path is broken underneath a
run, once for each fault a one-card training cell can have, and for the
float8 control put in the program's place.  (A cell at world 1 has no
exchange between chips, and its answer is the step's update, which the
first fault leaves out.)"""
import json
from pathlib import Path

import pytest
import torch

from bench import check, harness
from bench.test_bench_harness import BENCH, ROOT, tiny_spec
from bench.weights import batches

CELLS = [w["name"] for w in BENCH["workloads"]]


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    import repro_torch.optim.sgd as sgd_mod

    real = sgd_mod.sgd

    def frozen(lr, momentum=0.9, weight_decay=0.0):
        opt = real(lr, momentum, weight_decay)
        return sgd_mod.Optimizer(opt.init, lambda grads, state, params: (params, state))

    monkeypatch.setattr(sgd_mod, "sgd", frozen)
    result, _ = harness.run(tiny_spec(CELLS[0]), 31, 0.1, False, device="cpu")
    assert not result["correct"]
    assert result["checks"]["change"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_caught(monkeypatch):
    from repro_torch.comm import ddp

    real = ddp.make_ddp_train_step

    def halved(*args, **kwargs):
        step = real(*args, **kwargs)

        def half_step(params, state, batch):
            n = batch["tokens"].shape[0] // 2
            return step(params, state, {k: v[:n] for k, v in batch.items()})
        return half_step

    monkeypatch.setattr(ddp, "make_ddp_train_step", halved)
    result, _ = harness.run(tiny_spec(CELLS[0]), 32, 0.1, False, device="cpu")
    assert not result["correct"]
    assert result["checks"]["grad"]["value"] > 10 * result["checks"]["grad"]["limit"]


def _control_gaps(spec, seed, device):
    c, t = spec["config"], spec["traffic"]
    bs = [b for _, b in zip(range(t["check_steps"]),
                            batches(seed, c["vocab_size"], t["rows"], t["seq_len"]))]
    fam = harness.family(c)
    ref = check.follow(fam, c, seed, bs, t["lr"], t["momentum"], device)
    ctl = check.follow(fam, c, seed, bs, t["lr"], t["momentum"], device, matmul="fp8",
                       store=torch.bfloat16)
    return check.gaps(ctl, ref)


@pytest.mark.parametrize("seed", [41, 42, 43])
def test_the_float8_control_fails_at_tiny_widths(seed):
    spec = tiny_spec(CELLS[0])
    gaps = _control_gaps(spec, seed, "cpu")
    assert any(gaps[k] > spec["limits"][k] for k in gaps), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_float8_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's own size")
    spec = harness.load_spec(cell, ROOT)
    for seed in (401, 402, 403):
        gaps = _control_gaps(spec, seed, "cuda")
        assert any(gaps[k] > spec["limits"][k] for k in gaps), (seed, gaps)
        torch.cuda.empty_cache()
