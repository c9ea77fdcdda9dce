"""The port's decode path against the reference, on the CPU: the decode
attention oracles, the KV and ring-buffer caches, the recurrent state the
``R`` and ``W`` blocks carry from token to token, and the model's
``init_cache`` / ``prefill_via_decode`` / ``decode_step``, for every port
arch reduced (float32).

Parameters are initialised by the reference and carried over
(``transformer.from_reference``); tokens are drawn with numpy from a seed.
Tolerance: the f32 kernel tolerance of ``tests/test_kernels.py`` (2e-4),
of each tensor's scale.  The archs with ``L`` blocks (recurrentgemma-2b,
gemma3-1b) take an 8-token window in both packages, so that 20 tokens wrap
the ring buffer twice.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.models import blocks as jblocks
from repro.models import transformer as JT
from repro_torch.configs import get_config as torch_get_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru as trg
from repro_torch.kernels import wkv6 as twk
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import transformer as TT

ARCHS = ("qwen1.5-4b", "recurrentgemma-2b", "rwkv6-1.6b", "gemma3-1b",
         "internlm2-20b", "qwen1.5-32b", "qwen2-moe-a2.7b", "grok-1-314b")
DEPTH = {"recurrentgemma-2b": 3}
#: the reduced configs' overrides: 8 experts (so that top-k selects), an
#: 8-token window (so that the ring buffer wraps)
OVER = {"qwen2-moe-a2.7b": {"num_experts": 8}, "grok-1-314b": {"num_experts": 8},
        "recurrentgemma-2b": {"sliding_window": 8}, "gemma3-1b": {"sliding_window": 8}}
SEQ = 20
TOL = 2e-4


def _configs(arch, **over):
    over = {"num_layers": DEPTH.get(arch, 2), **OVER.get(arch, {}), **over}
    return jax_get_config(arch).reduced(**over), torch_get_config(arch).reduced(**over)


def _key_path(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "name", k)) for k in path)


def _jax_leaves(tree) -> list:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(_key_path(p), np.asarray(leaf)) for p, leaf in flat]


def _close(got, want, what, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-6)
    assert np.abs(got - want).max() <= tol * scale, (what, np.abs(got - want).max(), scale)


def _reference_params(jcfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, JT.init_lm(jcfg, jax.random.PRNGKey(seed)))


class TestDecodeAttentionOracles:
    @pytest.mark.parametrize("H,K", [(4, 4), (6, 2), (8, 1)])
    @pytest.mark.parametrize("n_valid", [1, 7, 16])
    def test_decode_attention_and_partials_match_reference(self, H, K, n_valid):
        """Grouped GQA (query head h reads kv head h // (H // K)) with a
        validity mask; the partials (o, m, l) and the normalised output."""
        rng = np.random.default_rng(H * 100 + n_valid)
        B, S, hd = 2, 16, 32
        q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
        k, v = (rng.standard_normal((B, S, K, hd)).astype(np.float32) for _ in range(2))
        valid = np.zeros(S, bool)
        valid[rng.permutation(S)[:n_valid]] = True
        jo, jm, jl = jref.decode_attention_partials(*map(jnp.asarray, (q, k, v, valid)))
        to, tm, tl = tops.decode_attention_partials(*map(torch.from_numpy, (q, k, v, valid)))
        for got, want, what in ((to, jo, "o"), (tm, jm, "m"), (tl, jl, "l")):
            assert got.dtype == torch.float32
            _close(got, want, what)
        out = tops.decode_attention(*map(torch.from_numpy, (q, k, v, valid)))
        _close(out, jref.decode_attention(*map(jnp.asarray, (q, k, v, valid))), "out")

    def test_decode_attention_keeps_the_query_dtype_and_equals_full_attention(self):
        """One query at the last position against the whole cache equals
        the last row of causal attention over the same keys."""
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(2, 12, h, 16, generator=g) for h in (4, 2, 2))
        full = tref.attention(q, k, v, causal=True)
        one = tref.decode_attention(q[:, -1:], k, v, torch.ones(12, dtype=torch.bool))
        torch.testing.assert_close(one, full[:, -1:], rtol=1e-5, atol=1e-6)
        assert tref.decode_attention(q[:, -1:].bfloat16(), k.bfloat16(), v.bfloat16(),
                                     torch.ones(12, dtype=torch.bool)).dtype == torch.bfloat16


class TestCaches:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_init_cache_layout_equals_reference(self, arch):
        """Key paths, shapes and dtypes of every cache leaf in flatten order,
        the stacked ``units`` leaves with their leading unit axis; the ring
        buffer of an ``L`` block holds min(seq_len, window) slots."""
        jcfg, tcfg = _configs(arch)
        jl = [(p, np.asarray(leaf)) for p, leaf in _jax_leaves(JT.init_cache(jcfg, 2, SEQ))]
        tl = list(TT.leaf_order(TT.init_cache(tcfg, 2, SEQ)))
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (path, j), (_, t) in zip(jl, tl):
            assert tuple(j.shape) == tuple(t.shape), path
            assert str(j.dtype) == str(t.dtype).removeprefix("torch."), path
            assert not t.any()
        if "L" in tcfg.layer_pattern:
            ring = [t for p, t in tl if p[-1] == "k" and t.shape[-3] == 8]
            assert ring, "no ring buffer of the window's 8 slots"

    def test_seq_axis_and_c_blocks_raise(self):
        """A mesh axis name as ``seq_axis`` raises ``TypeError``: the
        sequence-sharded decode takes a ``Comm`` (``tests/test_torch_seq_decode.py``);
        the ``C`` block's cache (ported with the encoder-decoder slice)
        equals the reference's: its self-attention kv cache only."""
        jcfg, tcfg = _configs("qwen1.5-4b")
        params = TT.init_lm(tcfg, seed=0)
        cache = TT.init_cache(tcfg, 1, 4)
        with pytest.raises(TypeError, match="repro_torch.comm.sync.Comm"):
            TT.decode_step(tcfg, params, cache, torch.zeros(1, dtype=torch.long), 0,
                           seq_axis="data")
        jl = _jax_leaves(jblocks.init_block_cache(jcfg, "C", 1, 4))
        tl = list(TT.leaf_order(tblocks.init_block_cache(tcfg, "C", 1, 4)))
        assert [p for p, _ in jl] == [p for p, _ in tl] == [("k",), ("v",)]
        for (path, j), (_, t) in zip(jl, tl):
            assert tuple(j.shape) == tuple(t.shape) and not t.any(), path
            assert str(j.dtype) == str(t.dtype).removeprefix("torch."), path

    def test_full_cache_refuses_a_position_past_its_end(self):
        _, tcfg = _configs("qwen1.5-4b")
        params = TT.init_lm(tcfg, seed=0)
        cache = TT.init_cache(tcfg, 1, 4)
        with pytest.raises(ValueError, match="outside the cache"):
            TT.decode_step(tcfg, params, cache, torch.zeros(1, dtype=torch.long), 4)

    @pytest.mark.parametrize("pos", [0, 5, 7, 8, 13, 19])
    def test_ring_buffer_slot_and_mask(self, pos, monkeypatch):
        """An 8-slot ring buffer: the new kv lands in slot pos % 8, and the
        mask lets through slots 0..pos before the wrap and every slot after,
        as the reference's ``(kv_idx <= slot) | (pos >= cache_len)``."""
        _, tcfg = _configs("gemma3-1b")
        p = TT.unit_slice(TT.init_lm(tcfg, seed=0)["units"], 0)["b0"]["attn"]
        cache = tattn.init_kv_cache(tcfg, 1, 32, window=8)
        seen = {}

        def spy(q, k, v, valid, impl="auto"):
            seen["valid"] = valid.clone()
            return tref.decode_attention(q, k, v, valid)

        monkeypatch.setattr(tattn.kops, "decode_attention", spy)
        x = torch.randn(1, 1, tcfg.d_model, generator=torch.Generator().manual_seed(pos))
        tattn.decode_attention(tcfg, p, x, cache, pos, window=8)
        written = [i for i in range(8) if cache["k"][0, i].any()]
        assert written == [pos % 8]
        idx = np.arange(8)
        want = (idx <= pos % 8) | (pos >= 8)
        assert seen["valid"].tolist() == want.tolist()


class TestDecodeAgainstReference:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_prefill_and_decode_step_logits_and_every_cache_leaf(self, arch):
        """``prefill_via_decode`` over 20 tokens into a cache of 21, then one
        ``decode_step`` at position 20: the logits at every position and
        every cache leaf after each, against the reference's (its ``lax.scan``
        prefill and its ``decode_step``)."""
        jcfg, tcfg = _configs(arch)
        tree = _reference_params(jcfg)
        rng = np.random.default_rng(7)
        tokens = rng.integers(0, jcfg.vocab_size, (2, SEQ)).astype(np.int32)
        nxt = rng.integers(0, jcfg.vocab_size, (2,)).astype(np.int32)
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
        jlog, jcache = JT.prefill_via_decode(jcfg, jparams, jnp.asarray(tokens), SEQ + 1)
        params = TT.from_reference(tree)
        tlog, tcache = TT.prefill_via_decode(tcfg, params, torch.from_numpy(tokens).long(),
                                             SEQ + 1)
        _close(tlog, jlog, "prefill logits")

        def same_cache(jc, tc, when):
            jl, tl = _jax_leaves(jc), list(TT.leaf_order(tc))
            assert [p for p, _ in jl] == [p for p, _ in tl]
            for (path, w), (_, g) in zip(jl, tl):
                _close(g, w, (when, path))

        same_cache(jcache, tcache, "after prefill")
        jl1, jcache = JT.decode_step(jcfg, jparams, jcache, jnp.asarray(nxt), jnp.int32(SEQ))
        tl1, tcache = TT.decode_step(tcfg, params, tcache, torch.from_numpy(nxt).long(), SEQ)
        assert tl1.shape == (2, tcfg.vocab_size) and tl1.dtype == torch.float32
        _close(tl1, jl1, "decode logits")
        same_cache(jcache, tcache, "after decode_step")


class TestDecodeAgainstForward:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_decode_equals_forward_at_every_position(self, arch):
        """The port's token-by-token decode against its own full-sequence
        ``forward`` over the same 20 tokens (flash and full-S scans on one
        side, caches and one-token scans on the other).  The MoE archs take
        a capacity factor at which no token is dropped, since a group of 64
        tokens and a group of one batch's tokens drop differently."""
        cf = {"capacity_factor": 8.0 / (2 if arch == "grok-1-314b" else 4)} \
            if arch in ("qwen2-moe-a2.7b", "grok-1-314b") else {}
        _, tcfg = _configs(arch, **cf)
        params = TT.init_lm(tcfg, seed=1)
        tokens = torch.from_numpy(np.random.default_rng(8).integers(0, tcfg.vocab_size,
                                                                     (2, SEQ)))
        with torch.no_grad():
            full = TT.forward(tcfg, params, tokens)
        dec, _ = TT.prefill_via_decode(tcfg, params, tokens, SEQ)
        _close(dec, full.numpy(), "decode vs forward")


class TestScanStateAtOneToken:
    def test_no_states_are_saved_without_grad(self, monkeypatch):
        """Under ``torch.no_grad`` the scan wrappers ask their forward for no
        saved states or checkpoints, even for inputs that require grad;
        with grad they do."""
        calls = []
        for mod, name in ((trg, "save_states"), (twk, "save_ckpt")):
            orig = mod.fwd

            def spy(*a, _orig=orig, _name=name, **kw):
                calls.append(kw.get(_name, False))
                return _orig(*a, **kw)

            monkeypatch.setattr(mod, "fwd", spy)
        g = torch.Generator().manual_seed(0)
        x, r, i = (torch.randn(2, 1, 8, generator=g, requires_grad=True) for _ in range(3))
        lam = torch.linspace(0.1, 2.0, 8)
        rk = [torch.randn(2, 1, 2, 32, generator=g, requires_grad=True) for _ in range(3)]
        w = torch.rand(2, 1, 2, 32, generator=g)
        u = torch.randn(2, 32, generator=g)
        with torch.no_grad():
            trg.rglru(x, r, i, lam, torch.zeros(2, 8))
            twk.wkv6(*rk, w, u, torch.zeros(2, 2, 32, 32))
        assert calls == [False, False]
        trg.rglru(x, r, i, lam)
        twk.wkv6(*rk, w, u)
        assert calls == [False, False, True, True]

    @pytest.mark.parametrize("arch,kind", [("recurrentgemma-2b", "R"), ("rwkv6-1.6b", "W")])
    def test_one_token_at_a_time_equals_the_whole_sequence(self, arch, kind):
        """A recurrent block fed one token at a time, carrying its state
        through ``decode_block``, gives the outputs of one ``apply_block``
        over the whole sequence."""
        _, tcfg = _configs(arch)
        p = TT.unit_slice(TT.init_lm(tcfg, seed=2)["units"], 0)
        p = p["b0"]
        x = torch.randn(2, 12, tcfg.d_model, generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            whole, _ = tblocks.apply_block(tcfg, kind, p, x)
            cache = tblocks.init_block_cache(tcfg, kind, 2, 12)
            steps = []
            for t in range(12):
                y, cache = tblocks.decode_block(tcfg, kind, p, x[:, t:t + 1], cache, t)
                steps.append(y)
        _close(torch.cat(steps, 1), whole.numpy(), "one token at a time")

    def test_reference_carries_the_same_block_state(self):
        """The ``R`` block's carried state (``h`` f32 and the conv's last
        kw - 1 inputs) and the ``W`` block's (the wkv state and both
        mixers' last tokens) after 12 tokens, against the reference's."""
        from repro.models import blocks as jblocks
        for arch, kind in (("recurrentgemma-2b", "R"), ("rwkv6-1.6b", "W")):
            jcfg, tcfg = _configs(arch)
            tree = jax.tree_util.tree_map(
                np.asarray, jblocks.init_block(jcfg, kind, jax.random.PRNGKey(4)))
            x = np.random.default_rng(9).standard_normal((2, 12, jcfg.d_model)) \
                .astype(np.float32)
            jc = jblocks.init_block_cache(jcfg, kind, 2, 12)
            tc = tblocks.init_block_cache(tcfg, kind, 2, 12)
            params = TT.from_reference(tree)
            for t in range(12):
                jy, jc = jblocks.decode_block(jcfg, kind, jax.tree_util.tree_map(
                    jnp.asarray, tree), jnp.asarray(x[:, t:t + 1]), jc, jnp.int32(t))
                ty, tc = tblocks.decode_block(tcfg, kind, params,
                                              torch.from_numpy(x[:, t:t + 1]), tc, t)
                _close(ty, jy, (arch, t))
            for key in jc:
                _close(tc[key], jc[key], (arch, key))


def test_reduced_window_override_reaches_both_packages():
    jcfg, tcfg = _configs("gemma3-1b")
    assert jcfg.sliding_window == tcfg.sliding_window == 8 < SEQ
    assert dataclasses.replace(tcfg).layer_pattern == "LG"
