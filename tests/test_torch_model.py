"""The port's model, loss and optimizer against the reference, on the CPU.

Parameters are initialised by the reference (``jax.random``) and carried
over by the port's bridge (``repro_torch.models.transformer.
from_reference``), so both sides start from the same values; tokens,
labels and cotangents are drawn with numpy from a seed.  Everything runs
in float32 (the reduced configs' dtype).  Tolerances: 1e-5 relative on
the loss, and per gradient leaf 2e-5 of that leaf's largest magnitude --
both sides sum the same float32 terms in different orders (matmul
blocking, the chunked loss), which moves the last few bits of each sum.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import common as jcommon
from repro.models import loss as jloss
from repro.models import transformer as JT
from repro.optim import sgd as jsgd
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import loss as tloss
from repro_torch.models import transformer as TT
from repro_torch.optim import sgd as tsgd

ARCH = "qwen1.5-4b"
_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _key_path(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "name", k)) for k in path)


def _jax_leaves(tree) -> list[tuple[tuple, np.ndarray]]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(_key_path(p), np.asarray(leaf)) for p, leaf in flat]


def _perturbed(tree, seed=0):
    """The reference's parameters as numpy, with the zero-initialised
    leaves (QKV biases, norm scales) set to small random values so their
    gradients are exercised."""
    rng = np.random.default_rng(seed)

    def leaf(x):
        x = np.array(x)
        if not x.any():
            x = (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map(leaf, tree)


def _configs(**over):
    return (jax_get_config(ARCH).reduced(**over), torch_get_config(ARCH).reduced(**over))


class TestConfig:
    @pytest.mark.parametrize("reduced", [False, True])
    def test_fields_equal_field_by_field(self, reduced):
        j, t = jax_get_config(ARCH), torch_get_config(ARCH)
        if reduced:
            j, t = j.reduced(), t.reduced()
        assert [f.name for f in dataclasses.fields(j)] == \
            [f.name for f in dataclasses.fields(t)]
        for f in dataclasses.fields(j):
            jv, tv = getattr(j, f.name), getattr(t, f.name)
            if f.name in ("dtype", "logit_dtype"):
                assert _DTYPES[jv] == tv, f.name
            elif f.name == "source":
                # the reference's registry cites the 0.5B model card for
                # these 4B widths; the port cites the 4B card
                assert (jv, tv) == ("hf:Qwen/Qwen1.5-0.5B", "hf:Qwen/Qwen1.5-4B")
            else:
                assert jv == tv, f.name
        for prop in ("kv_heads", "head_size", "num_units", "remainder_pattern",
                     "is_subquadratic", "rnn_size"):
            assert getattr(j, prop) == getattr(t, prop), prop

    def test_validate_rules_match(self):
        for mk in (lambda m: m.ModelConfig("x", "dense", 2, 64, 6, 128, 64, num_kv_heads=4),
                   lambda m: m.ModelConfig("x", "dense", 2, 64, 4, 128, 64, layer_pattern="GX")):
            with pytest.raises(ValueError):
                mk(jcommon).validate()
            with pytest.raises(ValueError):
                mk(tcommon).validate()

    def test_unported_block_kinds_raise(self):
        cfg = torch_get_config(ARCH).reduced()
        for kind in "RWC":
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                tblocks.init_block(cfg, kind, None, "meta")
        with pytest.raises(NotImplementedError, match="MoE"):
            tblocks.init_block(dataclasses.replace(cfg, num_experts=4, experts_per_token=2),
                               "G", None, "meta")


class TestNumerics:
    def test_rms_norm_and_layer_norm_fwd_bwd(self):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 5, 32)).astype(np.float32)
        s = (0.1 * rng.standard_normal(32)).astype(np.float32)
        b = (0.1 * rng.standard_normal(32)).astype(np.float32)
        ct = rng.standard_normal((2, 5, 32)).astype(np.float32)
        cases = [(jcommon.rms_norm, tcommon.rms_norm, (x, s)),
                 (jcommon.layer_norm, tcommon.layer_norm, (x, s, b))]
        for jf, tf, args in cases:
            jout, vjp = jax.vjp(jf, *map(jnp.asarray, args))
            jgrads = vjp(jnp.asarray(ct))
            targs = [torch.from_numpy(a).requires_grad_() for a in args]
            tout = tf(*targs)
            tgrads = torch.autograd.grad(tout, targs, torch.from_numpy(ct))
            np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=2e-6)
            for tg, jg in zip(tgrads, jgrads):
                np.testing.assert_allclose(_np(tg), np.asarray(jg), atol=2e-5)

    def test_apply_rope_fwd_bwd(self):
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 16, 3, 64)).astype(np.float32)
        pos = np.broadcast_to(np.arange(16) + 5, (2, 16)).astype(np.int32)
        ct = rng.standard_normal(x.shape).astype(np.float32)
        jout, vjp = jax.vjp(lambda a: jcommon.apply_rope(a, jnp.asarray(pos), 1e4),
                            jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_()
        tout = tcommon.apply_rope(tx, torch.from_numpy(pos), 1e4)
        (tg,) = torch.autograd.grad(tout, tx, torch.from_numpy(ct))
        np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=1e-5)
        np.testing.assert_allclose(_np(tg), np.asarray(vjp(jnp.asarray(ct))[0]), atol=1e-5)
        np.testing.assert_allclose(_np(tcommon.rope_frequencies(64, 1e4)),
                                   np.asarray(jcommon.rope_frequencies(64, 1e4)), rtol=1e-6)

    @pytest.mark.parametrize("V", [512, 20_000, 151_936])
    def test_num_chunks_rule(self, V):
        assert tloss._num_chunks(V, min(8192, V)) == jloss._num_chunks(V, min(8192, V))
        if V == 151_936:
            assert tloss._num_chunks(V, 8192) == 32 and V // 32 == 4748

    @pytest.mark.parametrize("V", [16_384, 20_000])
    def test_chunked_cross_entropy_fwd_bwd(self, V):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((2, 6, 32)).astype(np.float32)
        head = (rng.standard_normal((32, V)) / np.sqrt(32)).astype(np.float32)
        labels = rng.integers(0, V, (2, 6)).astype(np.int32)
        jl, jg = jax.value_and_grad(jloss.chunked_cross_entropy, argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(head), jnp.asarray(labels))
        tx, th = (torch.from_numpy(a).requires_grad_() for a in (x, head))
        tl = tloss.chunked_cross_entropy(tx, th, torch.from_numpy(labels).long())
        tg = torch.autograd.grad(tl, (tx, th))
        assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-6)
        for t, j in zip(tg, jg):
            j = np.asarray(j)
            assert np.abs(_np(t) - j).max() <= 1e-5 * np.abs(j).max()


class TestModel:
    def test_init_layout_equals_reference_at_full_width(self):
        """Key paths, shapes and dtypes of every leaf, in flatten order, for
        qwen1.5-4b at depth 2 (shapes only: the meta device and
        ``jax.eval_shape``)."""
        jcfg = dataclasses.replace(jax_get_config(ARCH), num_layers=2)
        tcfg = dataclasses.replace(torch_get_config(ARCH), num_layers=2)
        jshape = jax.eval_shape(lambda k: JT.init_lm(jcfg, k), jax.random.PRNGKey(0))
        jleaves = [(_key_path(p), leaf) for p, leaf in
                   jax.tree_util.tree_flatten_with_path(jshape)[0]]
        tleaves = list(TT.leaf_order(TT.init_lm(tcfg, device="meta")))
        assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
        for (path, j), (_, t) in zip(jleaves, tleaves):
            assert tuple(j.shape) == tuple(t.shape), path
            assert _DTYPES[jnp.dtype(j.dtype).type] == t.dtype, path
        assert TT.param_count(TT.init_lm(tcfg, device="meta")) == \
            sum(int(np.prod(j.shape)) for _, j in jleaves)

    def test_bridge_carries_every_leaf_in_flatten_order(self):
        jcfg, _ = _configs()
        tree = jax.tree_util.tree_map(np.asarray, JT.init_lm(jcfg, jax.random.PRNGKey(0)))
        params = TT.from_reference(tree)
        jl = _jax_leaves(tree)
        tl = list(TT.leaf_order(params))
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (_, a), (_, t) in zip(jl, tl):
            assert np.array_equal(a, t.numpy())

    def test_bridge_keeps_bfloat16(self):
        arr = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
        t = TT.from_reference({"w": arr})["w"]
        assert t.dtype == torch.bfloat16
        assert np.array_equal(np.asarray(arr, np.float32), t.float().numpy())

    @pytest.mark.parametrize("vocab", [512, 16_384])
    def test_loss_and_every_gradient_leaf_match(self, vocab):
        """Reduced qwen1.5-4b (2 layers, f32); vocab 16 384 takes the
        chunked cross-entropy on both sides."""
        jcfg, tcfg = _configs(num_layers=2, vocab_size=vocab)
        tree = _perturbed(jax.tree_util.tree_map(
            np.asarray, JT.init_lm(jcfg, jax.random.PRNGKey(0))))
        rng = np.random.default_rng(4)
        tokens = rng.integers(0, vocab, (2, 24)).astype(np.int32)
        labels = rng.integers(0, vocab, (2, 24)).astype(np.int32)

        def jloss_fn(p):
            return JT.loss_fn(jcfg, p, jnp.asarray(tokens), jnp.asarray(labels))[0]

        jl, jgrads = jax.value_and_grad(jloss_fn)(jax.tree_util.tree_map(jnp.asarray, tree))
        params = TT.from_reference(tree)
        paths, leaves = zip(*TT.leaf_order(params))
        for leaf in leaves:
            leaf.requires_grad_(True)
        tl, metrics = TT.loss_fn(tcfg, params, torch.from_numpy(tokens).long(),
                                 torch.from_numpy(labels).long())
        tgrads = torch.autograd.grad(tl, leaves)
        assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
        assert float(metrics["loss"].detach()) == pytest.approx(float(jl), rel=1e-5)
        jg = _jax_leaves(jgrads)
        assert [p for p, _ in jg] == list(paths)
        for (path, w), g in zip(jg, tgrads):
            scale = max(float(np.abs(w).max()), 1e-6)
            assert np.abs(_np(g) - w).max() <= 2e-5 * scale, path

    def test_forward_logits_match(self):
        jcfg, tcfg = _configs(num_layers=2)
        tree = _perturbed(jax.tree_util.tree_map(
            np.asarray, JT.init_lm(jcfg, jax.random.PRNGKey(1))))
        tokens = np.random.default_rng(5).integers(0, 512, (2, 16)).astype(np.int32)
        jlog, _ = JT.forward(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                             jnp.asarray(tokens))
        tlog = TT.forward(tcfg, TT.from_reference(tree), torch.from_numpy(tokens).long())
        assert tlog.dtype == torch.float32
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), atol=2e-4)


class TestOptimizer:
    @pytest.mark.parametrize("momentum,wd", [(0.9, 0.0), (0.9, 0.01), (0.0, 0.0)])
    def test_sgd_update_equals_reference(self, momentum, wd):
        rng = np.random.default_rng(6)
        params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
                  "b": {"c": rng.standard_normal(5).astype(np.float32),
                        "d": np.asarray(jnp.asarray(rng.standard_normal(6), jnp.bfloat16))}}
        grads = jax.tree_util.tree_map(
            lambda p: np.asarray(jnp.asarray(rng.standard_normal(p.shape), p.dtype)), params)
        jopt, topt = jsgd.sgd(0.1, momentum, wd), tsgd.sgd(0.1, momentum, wd)
        jst = jopt.init(jax.tree_util.tree_map(jnp.asarray, params))
        if momentum:   # a non-zero momentum state, the same on both sides
            jst = {"mom": jax.tree_util.tree_map(
                lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32), params)}
        tst = TT.from_reference(jax.tree_util.tree_map(np.asarray, jst))
        jp, jst2 = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), jst,
                               jax.tree_util.tree_map(jnp.asarray, params))
        tp, tst2 = topt.update(TT.from_reference(grads), tst, TT.from_reference(params))
        for (path, w), (tpath, t) in zip(_jax_leaves(jp), TT.leaf_order(tp)):
            assert path == tpath
            assert TT.from_reference({"x": w})["x"].dtype == t.dtype
            np.testing.assert_allclose(_np(t), np.asarray(w, np.float32), rtol=1e-6, atol=1e-7)
        if momentum:
            for (_, w), (_, t) in zip(_jax_leaves(jst2), TT.leaf_order(tst2)):
                np.testing.assert_allclose(_np(t), w, rtol=1e-6, atol=1e-7)

    def test_global_norm_equals_reference(self):
        rng = np.random.default_rng(7)
        tree = {"a": rng.standard_normal((4, 4)).astype(np.float32),
                "b": rng.standard_normal(9).astype(np.float32)}
        assert float(tsgd.global_norm(TT.from_reference(tree))) == pytest.approx(
            float(jsgd.global_norm(jax.tree_util.tree_map(jnp.asarray, tree))), rel=1e-6)
