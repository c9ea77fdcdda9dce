"""The port's model, loss and optimizer against the reference, on the CPU,
for each measured arch: qwen1.5-4b (``G`` blocks, untied head),
recurrentgemma-2b (``RRL``: RG-LRU and local-attention blocks, tied
embedding), rwkv6-1.6b (``W`` blocks: time mix and channel mix, layer
norm, untied head) and gemma3-1b (``LLLLLG``, reduced to ``LG``: windowed
and global attention with one kv head, tied embedding), and since the MoE
slice internlm2-20b (``G``, GQA 48/8, reduced to 4/4), qwen1.5-32b (``G``,
MHA with QKV bias), qwen2-moe-a2.7b (``G`` with the MoE MLP: shared
experts, top-4) and grok-1-314b (``G`` with the MoE MLP: top-2, no shared).
The reduced MoE configs take 8 experts (``MOE_OVER``), so that top-k
selects, and their loss tests also hold the aux loss (``moe_aux``); their
sequence of 40 tokens (80 a batch) pads the second group of 64.

Parameters are initialised by the reference (``jax.random``) and carried
over by the port's bridge (``repro_torch.models.transformer.
from_reference``), so both sides start from the same values; tokens,
labels and cotangents are drawn with numpy from a seed.  Everything runs
in float32 (the reduced configs' dtype).  Tolerances: 1e-5 relative on
the loss, and per gradient leaf 2e-5 of that leaf's largest magnitude --
both sides sum the same float32 terms in different orders (matmul
blocking, the chunked loss), which moves the last few bits of each sum.
Six of the whole rwkv6-1.6b model's gradient leaves are held to 1e-4
of their scale (``WIDE_LEAVES``): with vocab 16 384 the embedding,
``norm1/scale`` and ``time_mix`` mu, u, wk and wr read 1.8e-5 to 4.9e-5
of their scale between the two sides (each sums its float32 terms over
all tokens and through the wkv recurrence in its own order; at vocab 512
they read at most 9e-6).  Every other rwkv6 leaf, and its mixers on their
own, stay at 2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import loss as jloss
from repro.models import recurrent as jrec
from repro.models import transformer as JT
from repro.optim import sgd as jsgd
from repro_torch.configs import get_config as torch_get_config
from repro_torch.kernels import ref as tref
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import loss as tloss
from repro_torch.models import recurrent as trec
from repro_torch.models import transformer as TT
from repro_torch.optim import sgd as tsgd

ARCH = "qwen1.5-4b"
ARCHS = ("qwen1.5-4b", "recurrentgemma-2b", "rwkv6-1.6b", "gemma3-1b",
         "internlm2-20b", "qwen1.5-32b", "qwen2-moe-a2.7b", "grok-1-314b")
#: Reduced depth per arch: one whole layer pattern or more (recurrentgemma's
#: RRL needs 3 layers for one unit; gemma3-1b's LLLLLG reduces to LG at 2)
#: and the sequence length of the model tests (above recurrentgemma's and
#: gemma3-1b's reduced window of 64, so the window bites; above the wkv6
#: checkpoint interval of 64, so rwkv6's backward rebuilds two chunks).
DEPTH = {"qwen1.5-4b": 2, "recurrentgemma-2b": 3, "rwkv6-1.6b": 2, "gemma3-1b": 2,
         "internlm2-20b": 2, "qwen1.5-32b": 2, "qwen2-moe-a2.7b": 2, "grok-1-314b": 2}
SEQ = {"qwen1.5-4b": 24, "recurrentgemma-2b": 80, "rwkv6-1.6b": 80, "gemma3-1b": 80,
       "internlm2-20b": 24, "qwen1.5-32b": 24, "qwen2-moe-a2.7b": 40, "grok-1-314b": 40}
#: the reduced MoE configs' overrides: 8 experts (the default ``reduced()``
#: keeps 4, at which qwen2-moe's top-4 sends every token to every expert)
MOE_OVER = {"qwen2-moe-a2.7b": {"num_experts": 8}, "grok-1-314b": {"num_experts": 8}}
#: per-leaf gradient tolerance of the whole model, of the leaf's scale
GRAD_TOL = 2e-5
#: the leaves (by the end of their path) held to 1e-4 of their scale instead
WIDE_LEAVES = {"rwkv6-1.6b": (("embedding",), ("norm1", "scale"), ("time_mix", "mu"),
                              ("time_mix", "u"), ("time_mix", "wk"), ("time_mix", "wr"))}


def _grad_tol(arch: str, path: tuple) -> float:
    wide = any(path[-len(end):] == end for end in WIDE_LEAVES.get(arch, ()))
    return 1e-4 if wide else GRAD_TOL
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


def _configs(arch=ARCH, **over):
    over = {**MOE_OVER.get(arch, {}), **over}
    return (jax_get_config(arch).reduced(**over), torch_get_config(arch).reduced(**over))


class TestConfig:
    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("reduced", [False, True])
    def test_fields_equal_field_by_field(self, arch, reduced):
        j, t = _configs(arch, num_layers=DEPTH[arch]) if reduced else \
            (jax_get_config(arch), torch_get_config(arch))
        assert [f.name for f in dataclasses.fields(j)] == \
            [f.name for f in dataclasses.fields(t)]
        for f in dataclasses.fields(j):
            jv, tv = getattr(j, f.name), getattr(t, f.name)
            if f.name in ("dtype", "logit_dtype"):
                assert _DTYPES[jv] == tv, f.name
            elif f.name == "source" and arch == "qwen1.5-4b":
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
        """Every block kind is ported now: ``C`` (the encoder-decoder
        slice) initialises with the reference's keys, as do ``W``
        (rwkv6-1.6b) and a block with experts (the MoE slice); an unknown
        kind raises."""
        cfg = torch_get_config(ARCH).reduced()
        assert set(tblocks.init_block(cfg, "C", None, "meta")) == \
            set(jax.eval_shape(lambda k: jblocks.init_block(jax_get_config(ARCH).reduced(),
                                                            "C", k), jax.random.PRNGKey(0))) == \
            {"norm1", "attn", "norm_x", "xattn", "norm2", "mlp"}
        with pytest.raises(ValueError, match="unknown block kind"):
            tblocks.init_block(cfg, "X", None, "meta")
        assert set(tblocks.init_block(cfg, "W", None, "meta")) == \
            {"norm1", "time_mix", "norm2", "channel_mix"}
        moe = tblocks.init_block(dataclasses.replace(cfg, num_experts=4, experts_per_token=2),
                                 "G", None, "meta")
        assert set(moe) == {"norm1", "attn", "norm2", "moe"}
        assert set(moe["moe"]) == {"router", "wi", "wg", "wo"}


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

    @pytest.mark.parametrize("V", [512, 20_000, 151_936, 262_144])
    def test_num_chunks_rule(self, V):
        assert tloss._num_chunks(V, min(8192, V)) == jloss._num_chunks(V, min(8192, V))
        if V == 151_936:
            assert tloss._num_chunks(V, 8192) == 32 and V // 32 == 4748
        if V == 262_144:
            assert tloss._num_chunks(V, 8192) == 32 and V // 32 == 8192

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

    @pytest.mark.parametrize("values", ["wide", "dlogits"])
    def test_split3_is_exact(self, values):
        """hi + mid + lo == dlogits bit for bit (summed in float64, which
        holds the three terms' sum exactly): over magnitudes 1e-30 to 1e4 of
        both signs, and over (p - onehot) / N as the backward makes it."""
        g = torch.Generator().manual_seed(4)
        if values == "wide":
            mag = 10.0 ** (torch.rand(200_000, generator=g, dtype=torch.float64) * 34 - 30)
            sign = torch.randint(0, 2, mag.shape, generator=g) * 2 - 1
            d = (mag * sign).float()
        else:
            N, V = 96, 4096
            p = torch.softmax(3 * torch.randn(N, V, generator=g), dim=-1)
            onehot = torch.zeros(N, V).scatter_(1, torch.randint(0, V, (N, 1), generator=g), 1)
            d = ((p - onehot) * (1.0 / N)).reshape(-1)
        hi, mid, lo = tloss.split3(d)
        assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
        total = hi.double() + mid.double() + lo.double()
        assert torch.equal(total, d.double())
        assert int((mid != 0).sum()) > d.numel() // 2     # the split does work

    @pytest.mark.parametrize("head_kind", ["plain", "tied"])
    def test_split_products_match_the_f32_products(self, head_kind):
        """:func:`split_products` on the CPU, whose products of the bf16
        terms are f32 products, gives a chunk's dx and dhead within 1e-6 of
        the f32 products (norm-relative), for a head and for a tied head
        ``embedding.T``.  Both inner dimensions (c for dx, N for dhead)
        exceed ``ACC_BLOCK``, with a ragged last block."""
        g = torch.Generator().manual_seed(5)
        N, d, V, c = 1100, 64, 5000, 2500
        assert N % tloss.ACC_BLOCK and c % tloss.ACC_BLOCK and min(N, c) > tloss.ACC_BLOCK
        x = torch.randn(N, d, generator=g).bfloat16()
        if head_kind == "plain":
            head = (torch.randn(d, V, generator=g) / d ** 0.5).bfloat16()
        else:
            head = (torch.randn(V, d, generator=g) / d ** 0.5).bfloat16().T
            assert not head.is_contiguous()
        hc = head[:, c:2 * c]
        p = torch.softmax((x @ head).float(), dim=-1)[:, c:2 * c]
        onehot = torch.zeros(N, c).scatter_(1, torch.randint(0, c, (N, 1), generator=g), 1)
        dlogits = (p - onehot) * (1.0 / N)
        base = 1e-3 * torch.randn(N, d, generator=g)      # earlier chunks' sum

        dx = base.clone()
        dhc = tloss.split_products(dlogits, x, hc, dx)
        want_dx = base + dlogits @ hc.float().T
        want_dhc = x.float().T @ dlogits
        assert dhc.dtype == dx.dtype == torch.float32
        for got, want in ((dx, want_dx), (dhc, want_dhc)):
            assert float((got - want).norm() / want.norm()) <= 1e-6
        one = dlogits.bfloat16().float()                  # the lower precision it avoids
        assert float((x.float().T @ one - want_dhc).norm() / want_dhc.norm()) > 1e-4

    def test_a_shape_only_lowering_counts_the_split_whole(self):
        """On meta tensors, as a dry run lowers, the bf16 backward counts the
        split's six products of 2·N·d·V FLOPs beside the forward's and the
        recompute's logits, and takes each product whole: one dispatch a
        product, however many ``ACC_BLOCK`` the tokens span."""
        from torch.utils._python_dispatch import TorchDispatchMode

        from repro_torch.launch.dryrun import flop_counter

        class Products(TorchDispatchMode):
            calls = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                Products.calls += func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.addmm)
                return func(*args, **(kwargs or {}))

        N, d, V = 4 * tloss.ACC_BLOCK + 5, 64, 16_384
        x = torch.empty(1, N, d, dtype=torch.bfloat16, device="meta", requires_grad=True)
        head = torch.empty(d, V, dtype=torch.bfloat16, device="meta", requires_grad=True)
        labels = torch.zeros(1, N, dtype=torch.long, device="meta")
        with flop_counter() as fc, Products():
            torch.autograd.grad(tloss.chunked_cross_entropy(x, head, labels), (x, head))
        assert fc.get_total_flops() == 8 * 2 * N * d * V
        assert Products.calls == 8 * tloss._num_chunks(V, tloss.DEFAULT_CHUNK)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_chunked_cross_entropy_takes_the_f32_products_on_the_cpu(self, dtype, monkeypatch):
        """On the CPU every product of the backward is an f32 product.  f32
        inputs take the f32 path, and ``loss.split_chunks`` stays absent.
        bf16 inputs take the split (:func:`takes_split` is by dtype alone),
        whose products are the f32 products of the bf16 terms: the counter
        adds one a chunk, and the gradients lie within 2^-11 (norm-relative)
        of the f32 path's, where one bf16 term of ``dlogits``, the lower
        precision the split avoids, reads beyond it.  Both equal the f32
        products' formula."""
        from repro_torch import tracing

        g = torch.Generator().manual_seed(6)
        V, d = 16_384, 32
        x = torch.randn(2, 6, d, generator=g).to(dtype)
        head = (torch.randn(d, V, generator=g) / d ** 0.5).to(dtype)
        labels = torch.randint(0, V, (2, 6), generator=g)
        split = dtype == torch.bfloat16
        assert tloss.takes_split(x, head) == split

        def grads():
            xs, hs = x.clone().requires_grad_(), head.clone().requires_grad_()
            with tracing.record("cpu") as rec:
                out = torch.autograd.grad(tloss.chunked_cross_entropy(xs, hs, labels), (xs, hs))
            return out, rec.summary()["counters"].get("loss.split_chunks", 0)

        (gx, gh), n = grads()
        assert n == (tloss._num_chunks(V, tloss.DEFAULT_CHUNK) if split else 0)
        xf, hf = x.float(), head.float()
        dl = torch.softmax((x @ head).float(), dim=-1)
        dl[torch.arange(2)[:, None], torch.arange(6)[None, :], labels] -= 1
        dl /= 12
        want_x, want_h = dl @ hf.T, xf.reshape(12, d).T @ dl.reshape(12, V)
        torch.testing.assert_close(gx, want_x.to(dtype), rtol=1e-5 if dtype == torch.float32
                                   else 1e-2, atol=1e-7)
        torch.testing.assert_close(gh, want_h.to(dtype), rtol=1e-5 if dtype == torch.float32
                                   else 1e-2, atol=1e-7)
        if not split:
            return

        def rel(a, b):
            return float((a.float() - b.float()).norm() / b.float().norm())

        with monkeypatch.context() as m:
            m.setattr(tloss, "takes_split", lambda x, head: False)
            f32_path, _ = grads()
        with monkeypatch.context() as m:
            m.setattr(tloss, "split3", lambda t: (t.bfloat16(), *2 * [torch.zeros_like(
                t, dtype=torch.bfloat16)]))
            one_term, _ = grads()
        for got, ctl, want in zip((gx, gh), one_term, f32_path):
            assert rel(got, want) <= 2 ** -11 < rel(ctl, want)


class TestModel:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_init_layout_equals_reference_at_full_width(self, arch):
        """Key paths, shapes and dtypes of every leaf, in flatten order, at
        the published widths and one pattern's depth or two layers (shapes
        only: the meta device and ``jax.eval_shape``; gemma3-1b at 6).  recurrentgemma-2b's
        ``lam`` and rwkv6-1.6b's ``w_bias``, ``u`` and ``ln_scale`` stay
        float32 in the bf16 model."""
        depth = max(DEPTH[arch], len(jax_get_config(arch).layer_pattern))
        jcfg = dataclasses.replace(jax_get_config(arch), num_layers=depth)
        tcfg = dataclasses.replace(torch_get_config(arch), num_layers=depth)
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
        if arch == "recurrentgemma-2b":
            lam = dict(tleaves)[("units", "b0", "rglru", "lam")]
            assert lam.dtype == torch.float32 and tcfg.dtype == torch.bfloat16
            assert "lm_head" not in TT.init_lm(tcfg, device="meta")
        if arch == "rwkv6-1.6b":
            mix = {p[3]: leaf for p, leaf in tleaves if p[:3] == ("units", "b0", "time_mix")}
            assert {n: mix[n].dtype for n in ("w_bias", "u", "ln_scale")} == \
                dict.fromkeys(("w_bias", "u", "ln_scale"), torch.float32)
            assert tuple(mix["u"].shape) == (2, 32, 64) and mix["wr"].dtype == torch.bfloat16
            assert not any("mlp" in p for p, _ in tleaves)
        if tcfg.num_experts:
            leaves = dict(tleaves)
            assert leaves[("units", "b0", "moe", "router")].dtype == torch.float32
            assert tuple(leaves[("units", "b0", "moe", "wi")].shape) == \
                (2, tcfg.num_experts, tcfg.d_model, tcfg.moe_d_ff)
            assert (("units", "b0", "moe", "shared", "wo") in leaves) == \
                bool(tcfg.shared_expert_d_ff)
            assert not any("mlp" in p for p, _ in tleaves)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_bridge_carries_every_leaf_in_flatten_order(self, arch):
        jcfg, _ = _configs(arch, num_layers=DEPTH[arch])
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

    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("vocab", [512, 16_384])
    def test_loss_and_every_gradient_leaf_match(self, arch, vocab):
        """Reduced model (f32; qwen1.5-4b 2 layers, recurrentgemma-2b 3:
        RRL, gemma3-1b 2: LG, window 64 under 80 tokens); vocab 16 384 takes
        the chunked cross-entropy on both sides, through recurrentgemma's and
        gemma3-1b's tied heads.  The MoE archs' aux loss is held too, and
        every gradient leaf carries its share through the router."""
        jcfg, tcfg = _configs(arch, num_layers=DEPTH[arch], vocab_size=vocab)
        tree = _perturbed(jax.tree_util.tree_map(
            np.asarray, JT.init_lm(jcfg, jax.random.PRNGKey(0))))
        rng = np.random.default_rng(4)
        tokens = rng.integers(0, vocab, (2, SEQ[arch])).astype(np.int32)
        labels = rng.integers(0, vocab, (2, SEQ[arch])).astype(np.int32)

        def jloss_fn(p):
            return JT.loss_fn(jcfg, p, jnp.asarray(tokens), jnp.asarray(labels))

        (jl, jmetrics), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, tree))
        params = TT.from_reference(tree)
        paths, leaves = zip(*TT.leaf_order(params))
        for leaf in leaves:
            leaf.requires_grad_(True)
        tl, metrics = TT.loss_fn(tcfg, params, torch.from_numpy(tokens).long(),
                                 torch.from_numpy(labels).long())
        tgrads = torch.autograd.grad(tl, leaves)
        assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
        assert float(metrics["loss"].detach()) == pytest.approx(float(jmetrics["loss"]),
                                                                rel=1e-5)
        if tcfg.num_experts:
            assert float(metrics["moe_aux"].detach()) == pytest.approx(
                float(jmetrics["moe_aux"]), rel=1e-5)
            assert float(metrics["moe_aux"].detach()) > 0
            assert float(tl.detach()) == pytest.approx(
                float(metrics["loss"].detach()) + 0.01 * float(metrics["moe_aux"].detach()),
                rel=1e-6)
        else:
            # the reference's aux is 0 without experts; the port leaves it out
            assert float(jmetrics["moe_aux"]) == 0 and set(metrics) == {"loss"}
        jg = _jax_leaves(jgrads)
        assert [p for p, _ in jg] == list(paths)
        for (path, w), g in zip(jg, tgrads):
            scale = max(float(np.abs(w).max()), 1e-6)
            assert np.abs(_np(g) - w).max() <= _grad_tol(arch, path) * scale, path

    @pytest.mark.parametrize("arch", ARCHS)
    def test_forward_logits_match(self, arch):
        jcfg, tcfg = _configs(arch, num_layers=DEPTH[arch])
        tree = _perturbed(jax.tree_util.tree_map(
            np.asarray, JT.init_lm(jcfg, jax.random.PRNGKey(1))))
        tokens = np.random.default_rng(5).integers(0, 512, (2, SEQ[arch])).astype(np.int32)
        jlog, _ = JT.forward(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                             jnp.asarray(tokens))
        tlog = TT.forward(tcfg, TT.from_reference(tree), torch.from_numpy(tokens).long())
        assert tlog.dtype == torch.float32
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), atol=2e-4)


class TestRecurrentgemma:
    """The pieces recurrentgemma-2b adds: the recurrent block on its own,
    and the tied embedding (one leaf, used by the gather and as the head)."""

    def test_rglru_block_fwd_and_bwd_match_reference(self):
        """``rglru_block`` (projections, causal conv, scan, gated output) in
        f32 at the reduced width, the parameters the reference initialised
        (the zero conv bias perturbed): the output to 1e-5 of its scale,
        the input's and every parameter's gradient to 2e-5 of its scale."""
        jcfg, tcfg = _configs("recurrentgemma-2b", num_layers=DEPTH["recurrentgemma-2b"])
        tree = _perturbed(jax.tree_util.tree_map(
            np.asarray, jrec.init_rglru_block(jcfg, jax.random.PRNGKey(2))))
        rng = np.random.default_rng(8)
        x = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
        ct = rng.standard_normal(x.shape).astype(np.float32)
        jout, vjp = jax.vjp(lambda p, a: jrec.rglru_block(jcfg, p, a)[0],
                            jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
        jgp, jgx = vjp(jnp.asarray(ct))
        params = TT.from_reference(tree)
        paths, leaves = zip(*TT.leaf_order(params))
        tx = torch.from_numpy(x).requires_grad_()
        for leaf in leaves:
            leaf.requires_grad_(True)
        tout = trec.rglru_block(tcfg, params, tx)[0]
        tgrads = torch.autograd.grad(tout, (*leaves, tx), torch.from_numpy(ct))
        jout = np.asarray(jout)
        assert np.abs(_np(tout) - jout).max() <= 1e-5 * np.abs(jout).max()
        want = dict(_jax_leaves(jgp))
        assert list(want) == list(paths)
        for path, g in zip((*paths, ("x",)), tgrads):
            w = np.asarray(jgx) if path == ("x",) else want[path]
            assert np.abs(_np(g) - w).max() <= 2e-5 * max(float(np.abs(w).max()), 1e-6), path

    def test_tied_embedding_gradient_sums_gather_and_head(self):
        """The tied model's embedding gradient equals the untied model's
        embedding gradient (the gather) plus its head's gradient, transposed,
        when the head holds the same values."""
        _, tcfg = _configs("recurrentgemma-2b", num_layers=3, vocab_size=16_384)
        assert tcfg.tie_embeddings
        params = TT.init_lm(tcfg, seed=0)
        rng = np.random.default_rng(9)
        tokens, labels = (torch.from_numpy(rng.integers(0, 16_384, (2, 20))) for _ in range(2))
        emb = params["embedding"].requires_grad_()
        (g_tied,) = torch.autograd.grad(TT.loss_fn(tcfg, params, tokens, labels)[0], emb)
        untied = dataclasses.replace(tcfg, tie_embeddings=False)
        head = emb.detach().T.contiguous().requires_grad_()
        g_gather, g_head = torch.autograd.grad(
            TT.loss_fn(untied, {**params, "lm_head": head}, tokens, labels)[0], (emb, head))
        assert float(g_gather.abs().max()) > 0 and float(g_head.abs().max()) > 0
        torch.testing.assert_close(g_tied, g_gather + g_head.T, rtol=1e-5, atol=1e-7)

    def test_chunked_cross_entropy_takes_the_transposed_head_at_vocab_256000(self):
        """recurrentgemma-2b's head is ``embedding.T``, a non-contiguous
        (d, 256 000) view: 32 chunks of 8000 on both sides."""
        V, d = 256_000, 16
        assert tloss._num_chunks(V, 8192) == jloss._num_chunks(V, 8192) == 32
        rng = np.random.default_rng(10)
        x = rng.standard_normal((1, 4, d)).astype(np.float32)
        emb = (rng.standard_normal((V, d)) / np.sqrt(d)).astype(np.float32)
        labels = rng.integers(0, V, (1, 4)).astype(np.int32)
        jl, jg = jax.value_and_grad(
            lambda a, e: jloss.chunked_cross_entropy(a, e.T, jnp.asarray(labels)),
            argnums=(0, 1))(jnp.asarray(x), jnp.asarray(emb))
        tx, te = (torch.from_numpy(a).requires_grad_() for a in (x, emb))
        assert not te.T.is_contiguous()
        tl = tloss.chunked_cross_entropy(tx, te.T, torch.from_numpy(labels).long())
        tg = torch.autograd.grad(tl, (tx, te))
        assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-6)
        for t, j in zip(tg, jg):
            j = np.asarray(j)
            assert np.abs(_np(t) - j).max() <= 1e-5 * np.abs(j).max()


class TestRwkv6:
    """The pieces rwkv6-1.6b adds: the time mix (token shift, five lerps,
    the data-dependent decay, the wkv scan, the per-head RMS norm, the SiLU
    gate) and the channel mix (squared ReLU, sigmoid gate), each on its own
    at the reduced width (4 wkv heads of 64) in f32, from the parameters
    the reference initialised: the output to 1e-5 of its scale, the input's
    and every parameter's gradient to 2e-5 of its scale."""

    @pytest.mark.parametrize("mixer", ["time_mix", "channel_mix"])
    def test_mixer_fwd_and_bwd_match_reference(self, mixer):
        jcfg, tcfg = _configs("rwkv6-1.6b", num_layers=DEPTH["rwkv6-1.6b"])
        jinit, jfn = {"time_mix": (jrec.init_rwkv_time_mix, jrec.rwkv_time_mix),
                      "channel_mix": (jrec.init_rwkv_channel_mix, jrec.rwkv_channel_mix)}[mixer]
        tfn = {"time_mix": trec.rwkv_time_mix, "channel_mix": trec.rwkv_channel_mix}[mixer]
        tree = _perturbed(jax.tree_util.tree_map(np.asarray, jinit(jcfg, jax.random.PRNGKey(3))))
        rng = np.random.default_rng(11)
        x = rng.standard_normal((2, 70, jcfg.d_model)).astype(np.float32)
        ct = rng.standard_normal(x.shape).astype(np.float32)
        jout, vjp = jax.vjp(lambda p, a: jfn(jcfg, p, a)[0],
                            jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
        jgp, jgx = vjp(jnp.asarray(ct))
        params = TT.from_reference(tree)
        paths, leaves = zip(*TT.leaf_order(params))
        tx = torch.from_numpy(x).requires_grad_()
        for leaf in leaves:
            leaf.requires_grad_(True)
        tout = tfn(tcfg, params, tx)[0]
        tgrads = torch.autograd.grad(tout, (*leaves, tx), torch.from_numpy(ct))
        jout = np.asarray(jout)
        assert np.abs(_np(tout) - jout).max() <= 1e-5 * np.abs(jout).max()
        want = dict(_jax_leaves(jgp))
        assert list(want) == list(paths)
        for path, g in zip((*paths, ("x",)), tgrads):
            w = np.asarray(jgx) if path == ("x",) else want[path]
            assert np.abs(_np(g) - w).max() <= 2e-5 * max(float(np.abs(w).max()), 1e-6), path

    def test_decay_is_cast_to_the_activations_dtype(self, monkeypatch):
        """In a bf16 model the f32 decay is rounded to bf16 before the scan,
        as the reference's ``w.astype(r.dtype)``: decays near 1 become
        exactly 1.0."""
        tcfg = torch_get_config("rwkv6-1.6b").reduced(num_layers=2, dtype=torch.bfloat16)
        params = TT.unit_slice(TT.init_lm(tcfg, seed=0)["units"], 0)["b0"]["time_mix"]
        seen = {}

        def spy(r, k, v, w, u, state=None, impl="auto"):
            seen.update(r=r, w=w)
            return tref.wkv6(r, k, v, w, u, state)

        x = torch.randn(1, 5, tcfg.d_model, generator=torch.Generator().manual_seed(0))
        monkeypatch.setattr(trec.kops, "wkv6", spy)
        trec.rwkv_time_mix(tcfg, params, x.to(torch.bfloat16))
        assert seen["w"].dtype == seen["r"].dtype == torch.bfloat16
        assert bool((seen["w"] == 1.0).any()) and bool((seen["w"] <= 1.0).all())


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
