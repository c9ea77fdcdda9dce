"""The port's encoder-decoder and cross-attention path against the
reference, on the CPU: the two configs (whisper-tiny, llama-3.2-vision-90b),
the ``C`` block, the whisper encoder (``models/encdec.py``), the decoder
threaded with ``encoder_out``, the ``audio`` and ``vlm`` branches of
``launch/steps.py``, the launchers' dense-``G`` substitution, and the flash plain
versions at a kv length that differs from q's.

whisper-tiny is reduced to 2 decoder ``C`` layers and 2 encoder layers over
64 frames (d 256, 4 heads of 64, GELU, layer norm, QKV bias);
llama-3.2-vision-90b to ``GC`` (d 256, 4 heads on 4 kv heads, gated MLP)
with 16 image tokens.  Parameters are initialised by the reference and
carried over by ``transformer.from_reference`` (the encoder's layer list
included); tokens, frames and image embeddings are drawn with numpy from a
seed.  Everything is float32.  Tolerance: the f32 kernel tolerance of
``tests/test_kernels.py`` (``_tol``, 2e-4), of each tensor's scale.  One
gradient leaf is 0 in exact arithmetic: the cross-attention's key bias
(``xattn/bk``, whisper's QKV bias, no RoPE) adds q . bk to every score of
a query row, which the softmax cancels; both sides' round-off there
(~1e-9) is held to 2e-4 of the largest gradient leaf's scale instead
(``_grad_close``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.launch import steps as jsteps
from repro.models import blocks as jblocks
from repro.models import encdec as JED
from repro.models import transformer as JT
from repro.optim import sgd as jsgd
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as torch_get_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import blocks as tblocks
from repro_torch.models import encdec as TED
from repro_torch.models import transformer as TT
from repro_torch.optim import sgd as tsgd

ARCHS = ("whisper-tiny", "llama-3.2-vision-90b")
TOL = 2e-4
SEQ = 12
BATCH = 2
_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _configs(arch, **over):
    over = {"num_layers": 2, **over}
    return jax_get_config(arch).reduced(**over), torch_get_config(arch).reduced(**over)


def _key_path(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path)


def _jax_leaves(tree) -> list:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(_key_path(p), leaf) for p, leaf in flat]


def _close(got, want, what, tol=TOL, scale=None):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-6) if scale is None else scale
    assert np.abs(got - want).max() <= tol * scale, (what, np.abs(got - want).max(), scale)


def _grad_close(jgrads, tgrads):
    """Every gradient leaf within ``TOL`` of its scale; a leaf that is 0 in
    exact arithmetic (``xattn/bk``) within ``TOL`` of the largest leaf's."""
    jl, tl = _jax_leaves(jgrads), list(TT.leaf_order(tgrads))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    top = max(float(np.abs(np.asarray(w)).max()) for _, w in jl)
    for (path, w), (_, g) in zip(jl, tl):
        _close(g, w, path, scale=top if path[-2:] == ("xattn", "bk") else None)


def _perturbed(tree, seed=0):
    """The reference's parameters as numpy, with the zero-initialised
    leaves (QKV biases, norm biases and scales) set to small random values
    so their gradients are exercised."""
    rng = np.random.default_rng(seed)

    def leaf(x):
        x = np.array(x)
        if not x.any():
            x = (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map(leaf, tree)


def _reference_params(jcfg, seed=0):
    """The reference's ``steps.init_params`` tree (the encoder-decoder for
    whisper, the LM for llama-vision) as numpy, perturbed."""
    return _perturbed(jax.tree_util.tree_map(
        np.asarray, jsteps.init_params(jcfg, jax.random.PRNGKey(seed))), seed)


def _inputs(jcfg, seed=3):
    """tokens, labels (B, SEQ) int32 and the encoder input: frames (B, 64,
    d) for whisper, image embeddings (B, 16, d) for llama-vision."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    n = jcfg.encoder_seq if jcfg.arch_type == "audio" else jcfg.num_image_tokens
    enc = rng.standard_normal((BATCH, n, jcfg.d_model)).astype(np.float32)
    return tokens, labels, enc


def _t(x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(x)
    return t.long() if x.dtype == np.int32 else t


class TestConfigs:
    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("reduced", [False, True])
    def test_fields_equal_field_by_field(self, arch, reduced):
        j, t = _configs(arch) if reduced else (jax_get_config(arch), torch_get_config(arch))
        assert [f.name for f in dataclasses.fields(j)] == \
            [f.name for f in dataclasses.fields(t)]
        for f in dataclasses.fields(j):
            jv, tv = getattr(j, f.name), getattr(t, f.name)
            assert (_DTYPES[jv] if f.name in ("dtype", "logit_dtype") else jv) == tv, f.name
        for prop in ("kv_heads", "head_size", "num_units", "remainder_pattern"):
            assert getattr(j, prop) == getattr(t, prop), prop

    def test_registry_holds_the_references_ten_archs(self):
        from repro.configs import ARCH_IDS as JARCH_IDS
        assert set(ARCH_IDS) == set(JARCH_IDS) and len(ARCH_IDS) == 10


class TestLayout:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_c_block_key_paths_and_shapes(self, arch):
        jcfg, tcfg = jax_get_config(arch), torch_get_config(arch)
        jshape = jax.eval_shape(lambda k: jblocks.init_block(jcfg, "C", k),
                                jax.random.PRNGKey(0))
        jl = _jax_leaves(jshape)
        tl = list(TT.leaf_order(tblocks.init_block(tcfg, "C", None, "meta")))
        assert [p for p, _ in jl] == [p for p, _ in tl]
        assert {"norm_x", "xattn"} <= {p[0] for p, _ in tl}
        for (path, j), (_, t) in zip(jl, tl):
            assert tuple(j.shape) == tuple(t.shape), path
            assert _DTYPES[jnp.dtype(j.dtype).type] == t.dtype, path

    @pytest.mark.parametrize("arch", ARCHS)
    def test_init_params_layout_at_published_widths(self, arch):
        """whisper-tiny whole (4 + 4 layers); llama-vision at one ``GGGGC``
        unit.  Shapes only: ``jax.eval_shape`` and the meta device."""
        jcfg, tcfg = jax_get_config(arch), torch_get_config(arch)
        if arch != "whisper-tiny":
            jcfg, tcfg = (dataclasses.replace(c, num_layers=5) for c in (jcfg, tcfg))
        jl = _jax_leaves(jax.eval_shape(lambda k: jsteps.init_params(jcfg, k),
                                        jax.random.PRNGKey(0)))
        tparams = tsteps.init_params(tcfg, device="meta")
        tl = list(TT.leaf_order(tparams))
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (path, j), (_, t) in zip(jl, tl):
            assert tuple(j.shape) == tuple(t.shape), path
            assert _DTYPES[jnp.dtype(j.dtype).type] == t.dtype, path
        if arch == "whisper-tiny":
            assert isinstance(tparams["encoder"]["layers"], list)
            assert len(tparams["encoder"]["layers"]) == 4
            assert ("encoder", "layers", 3, "mlp", "wo") in dict(tl)
        else:
            assert TT.param_count(tparams) == 6_530_629_632

    @pytest.mark.parametrize("arch", ARCHS)
    def test_bridge_carries_the_reference_tree(self, arch):
        jcfg, _ = _configs(arch)
        tree = _reference_params(jcfg)
        params = TT.from_reference(tree)
        jl, tl = _jax_leaves(tree), list(TT.leaf_order(params))
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (_, a), (_, t) in zip(jl, tl):
            assert np.array_equal(a, t.numpy())
        back = TT.map_leaves(lambda _, t: t.numpy(), params)
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)


class TestEncoder:
    def test_encode_equals_reference(self):
        jcfg, tcfg = _configs("whisper-tiny")
        tree = _reference_params(jcfg)
        _, _, frames = _inputs(jcfg)
        want = JED.encode(jcfg, jax.tree_util.tree_map(jnp.asarray, tree["encoder"]),
                          jnp.asarray(frames))
        got = TED.encode(tcfg, TT.from_reference(tree)["encoder"], _t(frames))
        _close(got, want, "encoder states")


def _reference_loss(jcfg, jparams, tokens, labels, enc, remat):
    if jcfg.arch_type == "audio":
        return JED.loss_fn(jcfg, jparams, jnp.asarray(enc), jnp.asarray(tokens),
                           jnp.asarray(labels), remat=remat)
    return JT.loss_fn(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(labels),
                      encoder_out=jnp.asarray(enc), remat=remat)


class TestForwardAndGradients:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_forward_logits_match(self, arch):
        jcfg, tcfg = _configs(arch)
        tree = _reference_params(jcfg, seed=1)
        tokens, _, enc = _inputs(jcfg)
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
        params = TT.from_reference(tree)
        if arch == "whisper-tiny":
            want, _ = JED.forward(jcfg, jparams, jnp.asarray(enc), jnp.asarray(tokens))
            got = TED.forward(tcfg, params, _t(enc), _t(tokens))
        else:
            want, _ = JT.forward(jcfg, jparams, jnp.asarray(tokens),
                                 encoder_out=jnp.asarray(enc))
            got = TT.forward(tcfg, params, _t(tokens), encoder_out=_t(enc))
        assert got.dtype == torch.float32
        _close(got, want, "logits")

    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("remat", [False, True])
    def test_loss_and_every_gradient_leaf(self, arch, remat):
        """The loss and every parameter's gradient (the encoder's too)
        against ``jax.grad``, with and without ``remat``."""
        jcfg, tcfg = _configs(arch)
        tree = _reference_params(jcfg)
        tokens, labels, enc = _inputs(jcfg)
        (jl, _), jgrads = jax.value_and_grad(
            lambda p: _reference_loss(jcfg, p, tokens, labels, enc, remat), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, tree))
        total, metrics, grads = tsteps.loss_and_grads(
            tcfg, TT.from_reference(tree), _t(tokens), _t(labels), remat, encoder_in=_t(enc))
        assert float(total) == pytest.approx(float(jl), rel=1e-5)
        assert set(metrics) == {"loss"}
        if arch == "whisper-tiny":
            assert any(p[:2] == ("encoder", "layers") for p, _ in TT.leaf_order(grads))
        _grad_close(jgrads, grads)

    def test_c_block_needs_encoder_out(self):
        _, tcfg = _configs("whisper-tiny")
        params = TT.init_lm(tcfg, seed=0)
        with pytest.raises(ValueError, match="needs encoder_out"):
            TT.forward(tcfg, params, torch.zeros(1, 4, dtype=torch.long))


class TestDecode:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_prefill_and_decode_step_logits_and_every_cache_leaf(self, arch):
        """``prefill_via_decode`` over 8 tokens into a cache of 9, then one
        decode step at position 8 (``encdec.decode_step`` for whisper), the
        encoder states computed once: the logits at every position and
        every cache leaf (the ``C`` blocks' self-attention caches) after
        each, against the reference's."""
        n = 8
        jcfg, tcfg = _configs(arch)
        tree = _reference_params(jcfg, seed=2)
        tokens, _, enc = _inputs(jcfg)
        tokens, nxt = tokens[:, :n], tokens[:, n]
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
        params = TT.from_reference(tree)
        if arch == "whisper-tiny":
            jenc = JED.encode(jcfg, jparams["encoder"], jnp.asarray(enc))
            tenc = TED.encode(tcfg, params["encoder"], _t(enc))
            jdec, tdec = jparams["decoder"], params["decoder"]
        else:
            jenc, tenc, jdec, tdec = jnp.asarray(enc), _t(enc), jparams, params
        jlog, jcache = JT.prefill_via_decode(jcfg, jdec, jnp.asarray(tokens), n + 1,
                                             encoder_out=jenc)
        tlog, tcache = TT.prefill_via_decode(tcfg, tdec, _t(tokens), n + 1, encoder_out=tenc)
        _close(tlog, jlog, "prefill logits")

        def same_cache(jc, tc, when):
            jl, tl = _jax_leaves(jc), list(TT.leaf_order(tc))
            assert [p for p, _ in jl] == [p for p, _ in tl]
            for (path, w), (_, g) in zip(jl, tl):
                _close(g, w, (when, path))

        same_cache(jcache, tcache, "after prefill")
        if arch == "whisper-tiny":
            jl1, jcache = JED.decode_step(jcfg, jparams, jcache, jenc, jnp.asarray(nxt),
                                          jnp.int32(n))
            tl1, tcache = TED.decode_step(tcfg, params, tcache, tenc, _t(nxt), n)
        else:
            jl1, jcache = JT.decode_step(jcfg, jparams, jcache, jnp.asarray(nxt),
                                         jnp.int32(n), encoder_out=jenc)
            tl1, tcache = TT.decode_step(tcfg, params, tcache, _t(nxt), n, encoder_out=tenc)
        _close(tl1, jl1, "decode logits")
        same_cache(jcache, tcache, "after decode_step")

    @pytest.mark.parametrize("arch", ARCHS)
    def test_c_block_cache_equals_reference(self, arch):
        jcfg, tcfg = _configs(arch)
        jl = _jax_leaves(jblocks.init_block_cache(jcfg, "C", 2, 5))
        tl = list(TT.leaf_order(tblocks.init_block_cache(tcfg, "C", 2, 5)))
        assert [p for p, _ in jl] == [p for p, _ in tl] == [("k",), ("v",)]
        for (path, j), (_, t) in zip(jl, tl):
            assert tuple(j.shape) == tuple(t.shape) and not t.any(), path


def _batch(jcfg, kind):
    tokens, labels, enc = _inputs(jcfg, seed=5)
    key = "frames" if jcfg.arch_type == "audio" else "images"
    if kind == "train":
        return {"tokens": tokens, "labels": labels, key: enc}
    return {"tokens": tokens, key: enc}


class TestSteps:
    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("accum", [1, 2])
    def test_train_step_equals_reference(self, arch, accum):
        """One ``make_train_step`` update (SGD with momentum, ``remat`` on,
        ``accum_steps`` microbatches of tokens and frames or images): the
        new parameters, the momentum and the metrics."""
        jcfg, tcfg = _configs(arch)
        tree = _reference_params(jcfg)
        batch = _batch(jcfg, "train")
        jopt, topt = jsgd.sgd(0.1, momentum=0.9), tsgd.sgd(0.1, momentum=0.9)
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        jp, js, jm = jsteps.make_train_step(jcfg, jopt, accum_steps=accum)(
            jp, jopt.init(jp), jax.tree_util.tree_map(jnp.asarray, batch))
        tp = TT.from_reference(tree)
        tp, ts, tm = tsteps.make_train_step(tcfg, topt, accum_steps=accum)(
            tp, topt.init(tp), {k: _t(v) for k, v in batch.items()})
        for k in ("total_loss", "loss", "moe_aux", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=2e-4, abs=1e-7), k
        jl, tl = _jax_leaves(jp), list(TT.leaf_order(tp))
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (path, w), (_, g) in zip(jl, tl):
            _close(g, w, path)
        _grad_close(js["mom"], ts["mom"])

    @pytest.mark.parametrize("arch", ARCHS)
    def test_prefill_and_serve_steps_equal_reference(self, arch):
        jcfg, tcfg = _configs(arch)
        tree = _reference_params(jcfg, seed=4)
        batch = _batch(jcfg, "prefill")
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
        params = TT.from_reference(tree)
        want = jsteps.make_prefill_step(jcfg)(
            jparams, jax.tree_util.tree_map(jnp.asarray, batch))
        got = tsteps.make_prefill_step(tcfg)(params, {k: _t(v) for k, v in batch.items()})
        assert not got.requires_grad
        _close(got, want, "prefill step")

        dec = "encoder_states" if arch == "whisper-tiny" else "images"
        enc = batch["frames" if arch == "whisper-tiny" else "images"]
        jenc, tenc = jnp.asarray(enc), _t(enc)
        if arch == "whisper-tiny":
            jenc = JED.encode(jcfg, jparams["encoder"], jenc)
            tenc = TED.encode(tcfg, params["encoder"], tenc)
        jcache = JT.init_cache(jcfg, BATCH, 4)
        tcache = TT.init_cache(tcfg, BATCH, 4)
        jserve, tserve_ = jsteps.make_serve_step(jcfg), tsteps.make_serve_step(tcfg)
        for pos in range(3):
            tok = batch["tokens"][:, pos]
            jl, jcache = jserve(jparams, {"cache": jcache, "token": jnp.asarray(tok),
                                          "pos": jnp.int32(pos), dec: jenc})
            tl, tcache = tserve_(params, {"cache": tcache, "token": _t(tok), "pos": pos,
                                          dec: tenc})
            _close(tl, jl, ("serve step", pos))

    @pytest.mark.parametrize("arch", ARCHS)
    def test_launchers_substitute_the_dense_backbone(self, arch):
        """The reference's launchers train and serve an ``audio`` or ``vlm``
        arch as ``replace(cfg, layer_pattern="G", arch_type="dense")``;
        ``steps.dense_backbone`` gives that config field for field, and both
        port launchers run it on the CPU."""
        jcfg, tcfg = _configs(arch)
        want = dataclasses.replace(jcfg, layer_pattern="G", arch_type="dense")
        got = tsteps.dense_backbone(tcfg)
        for f in dataclasses.fields(want):
            jv, tv = getattr(want, f.name), getattr(got, f.name)
            assert (_DTYPES[jv] if f.name in ("dtype", "logit_dtype") else jv) == tv, f.name
        assert tsteps.dense_backbone(torch_get_config("qwen1.5-4b")) is \
            torch_get_config("qwen1.5-4b")
        summary = ttrain.run(ttrain.build_argparser().parse_args(
            ["--arch", arch, "--steps", "2", "--batch", "2", "--seq", "8", "--policy",
             "single", "--device", "cpu"]))
        assert summary["arch"] == tcfg.name and np.isfinite(summary["loss_last"])
        served = tserve.main(["--arch", arch, "--batch", "2", "--prompt-len", "3", "--gen", "2",
                              "--device", "cpu"])
        assert served["generated"] == 2 and served["arch"] == tcfg.name


class TestCrossAttentionKernelPlainVersions:
    @pytest.mark.parametrize("B,Sq,Skv,H,K,hd", [
        (2, 10, 37, 4, 2, 32),      # ragged on both sides, a group of 2
        (3, 1, 29, 4, 1, 64),       # one query token (decode)
        (1, 33, 33, 2, 2, 32),      # bidirectional self-attention
        (2, 40, 9, 4, 4, 64),       # fewer kv rows than q rows
    ])
    def test_plain_forward_and_backward_equal_reference(self, B, Sq, Skv, H, K, hd):
        """``plain_fwd`` and ``plain_bwd`` (through ``flash_attention``'s
        autograd on the CPU) at ``causal=False`` against the reference's
        ``ref.attention`` and its ``jax.vjp``."""
        rng = np.random.default_rng(Sq * 100 + Skv)
        q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
        k = rng.standard_normal((B, Skv, K, hd)).astype(np.float32)
        v = rng.standard_normal((B, Skv, K, hd)).astype(np.float32)
        do = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
        want, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, causal=False),
                            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        o, lse = tfa.plain_fwd(_t(q), _t(k), _t(v), causal=False)
        assert lse.shape == (B, H, Sq)
        _close(o, want, "plain_fwd")
        leaves = [_t(x).requires_grad_() for x in (q, k, v)]
        out = tfa.flash_attention(*leaves, causal=False)
        _close(out, want, "flash_attention")
        for got, w, name in zip(torch.autograd.grad(out, leaves, _t(do)),
                                vjp(jnp.asarray(do)), "qkv"):
            _close(got, w, f"d{name}")
        _close(tops.attention(_t(q), _t(k), _t(v), causal=False, impl="kernel"), want,
               "ops.attention")

    def test_backward_delta_reads_the_float32_output(self, monkeypatch):
        """With a gradient wanted, the forward keeps its float32 output and
        the backward's delta = rowsum(dO * O) reads it, not the output
        rounded to bfloat16; without one, nothing extra is kept."""
        seen = []
        orig = tfa.bwd_delta
        monkeypatch.setattr(tfa, "bwd_delta", lambda o, do: seen.append(o.dtype) or orig(o, do))
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(1, 40, 2, 32, generator=g).bfloat16().requires_grad_()
                   for _ in range(3))
        out = tfa.flash_attention(q, k, v, causal=True)
        assert out.dtype == torch.bfloat16
        out.float().sum().backward()
        assert seen == [torch.float32]
        o, lse, o32 = tfa.fwd(q.detach(), k.detach(), v.detach(), True, None, out_f32=True)
        assert o32.dtype == torch.float32 and torch.equal(o32.to(torch.bfloat16), o)
        assert torch.equal(tfa.bwd_delta(o32, torch.ones_like(o)), o32.sum(-1).transpose(1, 2))
        with pytest.raises(ValueError, match="float32 output"):
            tfa.bwd_delta(o, torch.ones_like(o))

    @pytest.mark.parametrize("causal,window", [(True, None), (False, 4), (True, 4)])
    def test_causal_or_windowed_cross_attention_raises(self, causal, window):
        q, k = torch.zeros(1, 5, 2, 32), torch.zeros(1, 7, 2, 32)
        with pytest.raises(ValueError, match="causal=False and no window"):
            tops.attention(q, k, k, causal=causal, window=window, impl="kernel")
        with pytest.raises(ValueError, match="causal=False and no window"):
            tfa.bwd_dq(q, k, k, q, torch.zeros(1, 2, 5), torch.zeros(1, 2, 5), causal, window)
