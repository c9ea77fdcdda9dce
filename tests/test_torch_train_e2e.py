"""The port's ``train_e2e`` twin (``repro_torch.examples.train_e2e``)
against the reference's ``examples/train_e2e.py``, on the CPU.

Both run ``--preset small --steps 4 --ckpt-every 2`` from the same
parameters: the reference's ``PRNGKey(0)`` initialisation, carried into
the port by ``transformer.from_reference``.  Both read the same batches
(the synthetic dataset's numpy generator, seed 11).  The reports must
have the same keys and the three losses must agree within 1e-4 relative;
the reference's ``restore_checkpoint`` must read the twin's checkpoints
leaf for leaf.
"""
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.optim.sgd import sgd as jsgd
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.examples import train_e2e as twin
from repro_torch.models import transformer as TT

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--preset", "small", "--steps", "4", "--ckpt-every", "2"]
LOSSES = ("loss_first", "loss_min", "loss_last_mean10")


def _reference_main():
    spec = importlib.util.spec_from_file_location("reference_train_e2e",
                                                  ROOT / "examples" / "train_e2e.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _key_path(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_e2e")
    ref_report = _reference_main()([*ARGS, "--out-dir", str(tmp / "ref")])
    ps = twin.PRESETS["small"]
    jcfg = jax_get_config("gemma3-1b").reduced(
        num_layers=ps["num_layers"], d_model=ps["d_model"], num_heads=ps["num_heads"],
        d_ff=ps["d_ff"], vocab_size=ps["vocab_size"])
    jparams = jax.tree_util.tree_map(np.asarray, JT.init_lm(jcfg, jax.random.PRNGKey(0)))
    params = TT.from_reference(jparams)
    args = twin.parser().parse_args([*ARGS, "--out-dir", str(tmp / "port")])
    report = twin.run(args, "cpu", params=params)
    return {"tmp": tmp, "ref": ref_report, "port": report, "params": params,
            "jcfg": jcfg, "jparams": jparams}


def test_config_equals_the_references(runs):
    """The twin's presets build the reference's model: f32, one kv head of
    64, window 64, ``LG`` x 2 at ``small``, ``LLLLLG`` x 2 at ``full``."""
    for preset, pattern in (("small", "LG"), ("full", "LLLLLG")):
        cfg = twin.config(preset)
        ps = twin.PRESETS[preset]
        jcfg = jax_get_config("gemma3-1b").reduced(
            num_layers=ps["num_layers"], d_model=ps["d_model"], num_heads=ps["num_heads"],
            d_ff=ps["d_ff"], vocab_size=ps["vocab_size"])
        assert (cfg.layer_pattern, cfg.num_units) == (jcfg.layer_pattern, jcfg.num_units) \
            == (pattern, 2)
        assert (cfg.kv_heads, cfg.head_size, cfg.sliding_window) == \
            (jcfg.kv_heads, jcfg.head_size, jcfg.sliding_window) == (1, 64, 64)
        assert cfg.dtype == torch.float32


def test_reports_have_the_same_keys(runs):
    ref = json.loads((runs["tmp"] / "ref" / "report.json").read_text())
    port = json.loads((runs["tmp"] / "port" / "report.json").read_text())
    assert list(ref) == list(port) == list(runs["port"])
    assert len(port) == 10
    assert port["params_m"] == pytest.approx(ref["params_m"], rel=0, abs=0)
    assert (port["preset"], port["steps"]) == (ref["preset"], ref["steps"])


@pytest.mark.parametrize("key", LOSSES)
def test_losses_agree(runs, key):
    assert runs["port"][key] == pytest.approx(runs["ref"][key], rel=1e-4)


def test_loss_went_down(runs):
    assert runs["port"]["loss_last_mean10"] < runs["port"]["loss_first"]


@pytest.mark.parametrize("name", ["ckpt_2.npz", "ckpt_final.npz"])
def test_reference_reads_the_twins_checkpoints(runs, name):
    """``repro.checkpoint.ckpt.restore_checkpoint`` into the reference's
    templates (parameters and the SGD momentum) reads every leaf of the
    twin's file, equal to what the port's own reader gives; the final
    file equals the twin's trained parameters."""
    path = runs["tmp"] / "port" / name
    jparams = runs["jparams"]
    jstate = jsgd(3e-3, momentum=0.9).init(jparams)
    rp, rs, meta = jckpt.restore_checkpoint(path, jparams, jstate)
    tstate = {"mom": TT.map_leaves(lambda _, t: torch.zeros_like(t), runs["params"])}
    tp, ts, tmeta = tckpt.restore_checkpoint(path, runs["params"], tstate)
    assert meta == tmeta == {"step": 2 if name == "ckpt_2.npz" else 4}
    for jtree, ttree in ((rp, tp), (rs, ts)):
        jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
        tl = list(TT.leaf_order(ttree))
        assert [_key_path(p) for p, _ in jl] == [p for p, _ in tl]
        for (_, j), (path_, t) in zip(jl, tl):
            np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=str(path_))
    if name == "ckpt_final.npz":
        for path_, t in TT.leaf_order(tp):
            assert torch.equal(t, TT.get_path(runs["params"], path_)), path_
