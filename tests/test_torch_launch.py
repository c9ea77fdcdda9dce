"""The port's training and serving substrate against the reference, on the
CPU: AdamW, the data pipeline, checkpoints (files exchanged in both
directions), ``make_train_step`` with ``remat`` and ``accum_steps``, and
both launchers end to end with ``--device cpu``.

AdamW's f32 state is held to 1e-6 of its scale (XLA's ``pow`` and
torch's may round the bias corrections differently in the last bit), its
bfloat16 parameters to one bfloat16 step.  ``make_train_step(accum_steps=2)``
is held to the reference's at the f32 kernel tolerance (2e-4 of scale).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro.optim import sgd as jsgd
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import get_config as torch_get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TT
from repro_torch.optim import sgd as tsgd


def _bf16_np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _tiny(arch="qwen1.5-4b", **over):
    over = {"num_layers": 2, "d_model": 64, "num_heads": 2, "d_ff": 128,
            "vocab_size": 128, **over}
    return jax_get_config(arch).reduced(**over), torch_get_config(arch).reduced(**over)


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------
class TestAdamW:
    @pytest.mark.parametrize("wd", [0.0, 0.1])
    def test_update_equals_reference_over_steps(self, wd):
        rng = np.random.default_rng(1)
        params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
                  "b": {"c": rng.standard_normal(5).astype(np.float32),
                        "d": _bf16_np(rng.standard_normal(6))}}
        jopt, topt = jsgd.adamw(0.01, weight_decay=wd), tsgd.adamw(0.01, weight_decay=wd)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        js = jopt.init(jp)
        tp = TT.from_reference(params)
        ts = topt.init(tp)
        for _ in range(5):
            grads = jax.tree_util.tree_map(
                lambda p: np.asarray(jnp.asarray(rng.standard_normal(p.shape), p.dtype)),
                params)
            jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
            tp, ts = topt.update(TT.from_reference(grads), ts, tp)
        assert int(ts["step"]) == int(js["step"]) == 5 and ts["step"].dtype == torch.int32
        for key in ("m", "v"):
            for (path, got), want in zip(TT.leaf_order(ts[key]),
                                         jax.tree_util.tree_leaves(js[key])):
                want = np.asarray(want)
                assert got.dtype == torch.float32
                assert np.abs(_np(got) - want).max() <= 1e-6 * np.abs(want).max(), path
        for (path, got), want in zip(TT.leaf_order(tp), jax.tree_util.tree_leaves(jp)):
            want = np.asarray(want, np.float32)
            if got.dtype == torch.bfloat16:
                ulp = np.abs(want) * 2.0 ** -7
                assert (np.abs(_np(got) - want) <= ulp).all(), path
            else:
                assert np.abs(_np(got) - want).max() <= 1e-6 * np.abs(want).max(), path

    def test_bias_corrections_are_float32_tensor_powers(self):
        """The step stays an int32 tensor on the parameters' device, and the
        update never reads it on the host."""
        p = {"w": torch.ones(3)}
        opt = tsgd.adamw(0.1)
        st = opt.init(p)
        assert st["step"].shape == () and st["step"].device == p["w"].device
        opt.update({"w": torch.ones(3)}, st, p)
        assert int(st["step"]) == 1

    def test_converges_on_quadratic(self):
        p = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(1.5)}
        opt = tsgd.adamw(0.05, weight_decay=0.0)
        st = opt.init(p)
        for _ in range(120):
            opt.update({k: 2 * v for k, v in p.items()}, st, p)
        assert float(sum((v ** 2).sum() for v in p.values())) < 1e-2


# ----------------------------------------------------------------------
# Pipeline
# ----------------------------------------------------------------------
class TestPipeline:
    def test_batches_equal_the_reference(self):
        jit, tit = (iter(m.SyntheticLMDataset(100, 8, 4, seed=7)) for m in (jpipe, tpipe))
        for _ in range(3):
            jb, tb = next(jit), next(tit)
            for k in ("tokens", "labels"):
                assert tb[k].dtype == jb[k].dtype == np.int32
                np.testing.assert_array_equal(tb[k], jb[k])

    def test_shapes_and_determinism(self):
        b1, b2 = (next(iter(tpipe.SyntheticLMDataset(100, 8, 4, seed=7))) for _ in range(2))
        assert b1["tokens"].shape == (4, 8)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])

    def test_loader_stages_torch_tensors(self):
        loader = tpipe.PrefetchLoader(tpipe.SyntheticLMDataset(50, 8, 2, seed=3), depth=2,
                                      device="cpu")
        want = next(iter(tpipe.SyntheticLMDataset(50, 8, 2, seed=3)))
        b = next(loader)
        loader.close()
        assert not loader._thread.is_alive()
        assert isinstance(b["tokens"], torch.Tensor) and b["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(b["tokens"].numpy(), want["tokens"])

    def test_prefetch_overlaps_io(self):
        """With depth=2 the consumer does not pay the injected fetch
        latency every step (the paper's I/O-overlap optimization)."""
        import time
        delay = 0.05
        loader = tpipe.PrefetchLoader(tpipe.SyntheticLMDataset(50, 8, 2,
                                                               simulate_io_seconds=delay),
                                      depth=2, device="cpu")
        next(loader)
        time.sleep(3 * delay)
        t0 = time.perf_counter()
        for _ in range(2):
            next(loader)
        elapsed = time.perf_counter() - t0
        loader.close()
        assert elapsed < 2 * delay

    def test_depth0_blocks(self):
        loader = tpipe.PrefetchLoader(tpipe.SyntheticLMDataset(50, 8, 2), depth=0,
                                      device="cpu")
        b = next(loader)
        assert b["tokens"].shape == (2, 8)
        assert loader.mean_t_io() >= 0.0 and loader.batches == 1

    def test_default_device_is_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device exists")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipe.PrefetchLoader(tpipe.SyntheticLMDataset(50, 8, 2), depth=0)


# ----------------------------------------------------------------------
# Checkpoints
# ----------------------------------------------------------------------
def _tree(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.integers(0, 9, (5,)).astype(np.int32),
                  "d": _bf16_np(rng.standard_normal(6))}}


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


class TestCheckpoint:
    def test_round_trip_is_bitwise_with_bfloat16(self, tmp_path):
        rng = np.random.default_rng(2)
        params = TT.from_reference(_tree(rng))
        opt = tsgd.adamw(0.1)
        st = opt.init(params)
        st["m"]["a"].normal_()
        tckpt.save_checkpoint(tmp_path / "c.npz", params, st, step=42, extra={"arch": "x"})
        zeros = TT.map_leaves(lambda _, t: torch.zeros_like(t), params)
        p2, s2, meta = tckpt.restore_checkpoint(tmp_path / "c.npz", zeros, opt.init(zeros))
        assert meta == {"step": 42, "arch": "x"}
        for tree, back in ((params, p2), (st, s2)):
            for (path, a), (_, b) in zip(TT.leaf_order(tree), TT.leaf_order(back)):
                assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b)), path

    def test_port_reads_the_reference_file(self, tmp_path):
        rng = np.random.default_rng(3)
        tree = _tree(rng)
        jckpt.save_checkpoint(tmp_path / "r.npz", jax.tree_util.tree_map(jnp.asarray, tree),
                              {"mom": {"a": tree["a"] * 2}}, step=7)
        like = TT.map_leaves(lambda _, t: torch.zeros_like(t), TT.from_reference(tree))
        p, s, meta = tckpt.restore_checkpoint(tmp_path / "r.npz", like,
                                              {"mom": {"a": torch.zeros(3, 4)}})
        assert meta["step"] == 7 and p["b"]["d"].dtype == torch.bfloat16
        for (path, want), (_, got) in zip(TT.leaf_order(TT.from_reference(tree)),
                                          TT.leaf_order(p)):
            assert np.array_equal(_bits(want), _bits(got)), path
        assert np.array_equal(s["mom"]["a"].numpy(), tree["a"] * 2)

    def test_reference_reads_the_port_file(self, tmp_path):
        """The reference's ``restore_checkpoint`` takes the port's file
        leaf for leaf.  It cannot restore a bfloat16 leaf from any file, its
        own included (``jnp.asarray`` of a ``|V2`` array has no cast), so
        the bfloat16 leaf is held at the file: the same ``|V2`` bits that
        the reference's own ``np.savez`` writes."""
        rng = np.random.default_rng(4)
        tree = _tree(rng)
        params = TT.from_reference(tree)
        tckpt.save_checkpoint(tmp_path / "t.npz", params, {"step": torch.tensor(3)}, step=3)
        jckpt.save_checkpoint(tmp_path / "r.npz", jax.tree_util.tree_map(jnp.asarray, tree))
        no_bf16 = {"a": tree["a"], "b": {"c": tree["b"]["c"]}}
        jp, js, meta = jckpt.restore_checkpoint(
            tmp_path / "t.npz", jax.tree_util.tree_map(jnp.asarray, no_bf16),
            {"step": jnp.zeros((), jnp.int32)})
        assert meta["step"] == 3 and int(js["step"]) == 3
        np.testing.assert_array_equal(np.asarray(jp["a"]), tree["a"])
        np.testing.assert_array_equal(np.asarray(jp["b"]["c"]), tree["b"]["c"])
        with np.load(tmp_path / "t.npz") as ours, np.load(tmp_path / "r.npz") as theirs:
            a, b = ours["params/b/d"], theirs["params/b/d"]
            assert a.dtype == b.dtype == np.dtype("V2")
            assert np.array_equal(a.view(np.uint16), b.view(np.uint16))
        with pytest.raises(ValueError, match="No cast function"):
            jckpt.restore_checkpoint(tmp_path / "r.npz", jax.tree_util.tree_map(jnp.asarray,
                                                                                 tree))

    def test_shape_mismatch_raises(self, tmp_path):
        tckpt.save_checkpoint(tmp_path / "s.npz", {"w": torch.zeros(2, 2)})
        with pytest.raises(ValueError, match="shape mismatch"):
            tckpt.restore_checkpoint(tmp_path / "s.npz", {"w": torch.zeros(3, 3)})


# ----------------------------------------------------------------------
# make_train_step
# ----------------------------------------------------------------------
def _batch(cfg, B=4, S=16, seed=5):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


class TestTrainStep:
    @pytest.mark.parametrize("arch", ["qwen1.5-4b", "recurrentgemma-2b", "rwkv6-1.6b"])
    def test_remat_gives_the_same_bits(self, arch):
        _, tcfg = _tiny(arch, num_layers=3 if arch == "recurrentgemma-2b" else 2,
                        d_model=128)
        batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
        outs = []
        for remat in (False, True):
            params = TT.init_lm(tcfg, seed=0)
            opt = tsgd.sgd(0.1)
            st = opt.init(params)
            step = tsteps.make_train_step(tcfg, opt, remat=remat)
            params, st, m = step(params, st, batch)
            outs.append((params, st, m))
        (p0, s0, m0), (p1, s1, m1) = outs
        for (path, a), (_, b) in zip(TT.leaf_order(s0["mom"]), TT.leaf_order(s1["mom"])):
            assert torch.equal(a, b), path
        for k in m0:
            assert torch.equal(m0[k], m1[k]), k

    def test_remat_runs_each_unit_forward_twice(self, monkeypatch):
        from repro_torch.models import blocks as tblocks
        _, tcfg = _tiny()
        calls = []
        orig = tblocks.apply_block
        monkeypatch.setattr(tblocks, "apply_block",
                            lambda *a, **kw: calls.append(1) or orig(*a, **kw))
        batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
        for remat, want in ((False, 2), (True, 4)):
            calls.clear()
            params = TT.init_lm(tcfg, seed=0)
            opt = tsgd.sgd(0.1)
            tsteps.make_train_step(tcfg, opt, remat=remat)(params, opt.init(params), batch)
            assert len(calls) == want

    @pytest.mark.parametrize("accum", [1, 2])
    def test_train_step_equals_reference(self, accum):
        """``make_train_step`` with SGD and momentum, ``remat`` on (the
        default) and ``accum_steps`` microbatches: the new parameters, the
        momentum and the metrics against the reference's."""
        jcfg, tcfg = _tiny()
        tree = jax.tree_util.tree_map(np.asarray, JT.init_lm(jcfg, jax.random.PRNGKey(0)))
        batch = _batch(jcfg)
        jopt, topt = jsgd.sgd(0.1, momentum=0.9), tsgd.sgd(0.1, momentum=0.9)
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        jstep = jax.jit(jsteps.make_train_step(jcfg, jopt, accum_steps=accum))
        jp, js, jm = jstep(jp, jopt.init(jp), jax.tree_util.tree_map(jnp.asarray, batch))
        tp = TT.from_reference(tree)
        tstep = tsteps.make_train_step(tcfg, topt, accum_steps=accum)
        tp, ts, tm = tstep(tp, topt.init(tp), {k: torch.from_numpy(v) for k, v in
                                               batch.items()})
        for k in ("total_loss", "loss", "moe_aux", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=2e-4, abs=1e-7), k
        for tree_t, tree_j in ((tp, jp), (ts["mom"], js["mom"])):
            for (path, g), w in zip(TT.leaf_order(tree_t), jax.tree_util.tree_leaves(tree_j)):
                w = np.asarray(w)
                assert np.abs(_np(g) - w).max() <= 2e-4 * max(np.abs(w).max(), 1e-6), path

    def test_accumulation_equals_one_batch(self):
        """Two microbatches of 2 sum to the gradient of the batch of 4 (the
        mean loss over equal halves), within f32 rounding."""
        _, tcfg = _tiny()
        batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
        moms = []
        for accum in (1, 2):
            params = TT.init_lm(tcfg, seed=0)
            opt = tsgd.sgd(0.1)
            _, st, _ = tsteps.make_train_step(tcfg, opt, accum_steps=accum)(
                params, opt.init(params), batch)
            moms.append(st["mom"])
        for (path, a), (_, b) in zip(TT.leaf_order(moms[0]), TT.leaf_order(moms[1])):
            torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-6 * float(a.abs().max())), path
        with pytest.raises(ValueError, match="microbatches"):
            tsteps.make_train_step(tcfg, tsgd.sgd(0.1), accum_steps=3)(
                TT.init_lm(tcfg, seed=0), {"mom": {}}, batch)

    def test_resume_is_bitwise(self, tmp_path):
        """AdamW: 3 steps, a checkpoint, 2 more; restored from the file, the
        same 2 steps give the same bits (the reference's
        ``test_checkpoint_resume_bitwise``)."""
        _, tcfg = _tiny()
        batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
        opt = tsgd.adamw(1e-3)
        step = tsteps.make_train_step(tcfg, opt, remat=False)
        params = TT.init_lm(tcfg, seed=1)
        st = opt.init(params)
        for _ in range(3):
            params, st, _ = step(params, st, batch)
        tckpt.save_checkpoint(tmp_path / "ck.npz", params, st, step=3)
        for _ in range(2):
            params, st, _ = step(params, st, batch)
        like = TT.init_lm(tcfg, seed=9)
        r_params, r_st, meta = tckpt.restore_checkpoint(tmp_path / "ck.npz", like,
                                                        opt.init(like))
        assert meta["step"] == 3
        for _ in range(2):
            r_params, r_st, _ = step(r_params, r_st, batch)
        for (path, a), (_, b) in zip(TT.leaf_order({"p": params, "s": st}),
                                     TT.leaf_order({"p": r_params, "s": r_st})):
            assert torch.equal(a, b), path

    def test_prefill_step_is_forward(self):
        _, tcfg = _tiny()
        params = TT.init_lm(tcfg, seed=0)
        tokens = torch.from_numpy(_batch(tcfg)["tokens"]).long()
        logits = tsteps.make_prefill_step(tcfg)(params, {"tokens": tokens})
        assert not logits.requires_grad
        torch.testing.assert_close(logits, TT.forward(tcfg, params, tokens))


# ----------------------------------------------------------------------
# Launchers
# ----------------------------------------------------------------------
class TestLaunchers:
    def test_training_reduces_loss(self, tmp_path):
        """The reference's ``test_training_reduces_loss`` through the port's
        launcher: AdamW at 3e-3 on random tokens, 30 steps, the last five
        losses below the first five."""
        summary = ttrain.run(ttrain.build_argparser().parse_args(
            ["--arch", "qwen1.5-4b", "--steps", "30", "--batch", "8", "--seq", "16",
             "--optimizer", "adamw", "--policy", "single", "--device", "cpu",
             "--log-every", "100", "--summary-json", str(tmp_path / "s.json")]))
        assert summary["world"] == 1 and summary["steps"] == 30
        assert np.isfinite(summary["loss_last"])
        assert summary["loss_last"] < summary["loss_first"]
        assert json.loads((tmp_path / "s.json").read_text()) == summary
        assert set(summary) == {"arch", "steps", "world", "policy", "loss_first", "loss_last",
                                "mean_step_s", "t_io_mean", "t_h2d_mean", "samples_per_s"}

    def test_train_launcher_checkpoint_restores(self, tmp_path):
        ck = tmp_path / "ck.npz"
        ttrain.main(["--arch", "gemma3-1b", "--steps", "3", "--batch", "4", "--seq", "32",
                     "--policy", "single", "--optimizer", "adamw", "--device", "cpu",
                     "--checkpoint", str(ck)])
        tcfg = torch_get_config("gemma3-1b").reduced(num_layers=2)
        like = TT.init_lm(tcfg, seed=5)
        params, st, meta = tckpt.restore_checkpoint(ck, like, tsgd.adamw(1.0).init(like))
        assert meta["step"] == 3 and int(st["step"]) == 3
        assert not torch.equal(params["embedding"], TT.init_lm(tcfg, seed=0)["embedding"])

    def test_data_parallel_launcher_on_two_gloo_ranks(self):
        summary = ttrain.run(ttrain.build_argparser().parse_args(
            ["--arch", "qwen1.5-4b", "--steps", "3", "--batch", "4", "--seq", "16",
             "--data-parallel", "2", "--policy", "wfbp", "--device", "cpu"]))
        assert summary["world"] == 2 and summary["policy"] == "wfbp"
        assert np.isfinite(summary["loss_last"]) and summary["mean_step_s"] > 0

    def test_serve_summary_has_the_reference_keys(self):
        from repro.launch import serve as jserve
        args = ["--arch", "rwkv6-1.6b", "--batch", "2", "--prompt-len", "4", "--gen", "3"]
        ours = tserve.main(args + ["--device", "cpu"])
        theirs = jserve.main(args)
        assert set(ours) == set(theirs)
        assert ours["generated"] == 3 and ours["decode_tok_per_s"] > 0
        assert len(ours["sample_tokens"]) == 3 and ours["arch"] == theirs["arch"]

    def test_launchers_need_a_gpu_unless_asked(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["--batch", "1", "--prompt-len", "2", "--gen", "2"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.main(["--steps", "1"])


def test_quickstart_twin_runs_the_three_layers(capsys):
    """``repro_torch.examples.quickstart`` on the CPU: the DAG model's
    ResNet-50 predictions ``==`` the reference's ``predict_cnn``, a few
    finite training losses through the prefetching loader, and the
    two-layer trace with its gradient bytes."""
    from repro.core.hardware import V100_CLUSTER
    from repro.core.policies import CAFFE_MPI, CNTK
    from repro.core.predictor import predict_cnn
    from repro_torch.examples import quickstart

    out = quickstart.run("cpu", steps=3)
    assert out["predictions"] == {pol.name: predict_cnn("resnet50", V100_CLUSTER, 16,
                                                        pol).iteration_time
                                  for pol in (CAFFE_MPI, CNTK)}
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert [(r.name, r.size_bytes) for r in out["trace"]] == [("fc1", 131072.0),
                                                              ("fc2", 65536.0)]
    assert "done." in capsys.readouterr().out
