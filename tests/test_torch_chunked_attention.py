"""The port's chunked attention (``repro_torch.kernels.chunked_attention``)
against the reference's (``repro.kernels.chunked_attention``) and the
port's plain ``ref.attention``, forward and the gradients of q, k and v,
on the CPU; and ``ops.attention``'s routing: CPU self-attention at
S >= ``CHUNKED_ATTENTION_MIN_SEQ`` takes the chunked path as in the
reference, CUDA and meta tensors keep the flash kernels.

Inputs are drawn with numpy from a seed; everything is float32.
Tolerance: 1e-4, the reference's own ``TestChunkedAttention`` limit, for
the function; 2e-4 of the logits' scale (the f32 ``_tol`` of
``tests/test_kernels.py``) for the model at 2048 tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import chunked_attention as jca
from repro.kernels import ops as jops
from repro.models import transformer as JT
from repro_torch.configs import get_config as torch_get_config
from repro_torch.kernels import chunked_attention as tca
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as TT

TOL = 1e-4
B, S, H, K, HD, BLOCK = 1, 256, 4, 2, 32, 64


def _inputs(seed, s=S, h=H, k=K):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s, h, HD)).astype(np.float32)
    kk, v = (rng.standard_normal((B, s, k, HD)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, s, h, HD)).astype(np.float32)
    return q, kk, v, do


def _port(q, k, v, do, fn):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fn(tq, tk, tv)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(do))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def _close(got, want, what, tol=TOL):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= tol, (what, float(np.abs(got - want).max()))


class TestChunkedAttention:
    @pytest.mark.parametrize("window", [None, 96])
    def test_forward_and_gradients_match_reference(self, window):
        """GQA (4 query heads on 2 kv heads), blocks of 64: the output and
        dq, dk, dv against ``jax.vjp`` of the reference's custom VJP."""
        q, k, v, do = _inputs(1 if window is None else 2)
        out, vjp = jax.vjp(lambda a, b, c: jca.chunked_attention(a, b, c, True, window,
                                                                 BLOCK, BLOCK),
                           *map(jnp.asarray, (q, k, v)))
        want = [out, *vjp(jnp.asarray(do))]
        got = _port(q, k, v, do, lambda a, b, c: tca.chunked_attention(a, b, c, True, window,
                                                                        BLOCK, BLOCK))
        for g, w, what in zip(got, want, ("out", "dq", "dk", "dv")):
            _close(g, w, what)

    @pytest.mark.parametrize("window", [None, 96])
    def test_forward_and_gradients_match_plain_attention(self, window):
        """The same against the port's ``ref.attention`` and autograd."""
        q, k, v, do = _inputs(3 if window is None else 4)
        want = _port(q, k, v, do, lambda a, b, c: tref.attention(a, b, c, causal=True,
                                                                 window=window))
        got = _port(q, k, v, do, lambda a, b, c: tca.chunked_attention(a, b, c, True, window,
                                                                        BLOCK, BLOCK))
        for g, w, what in zip(got, want, ("out", "dq", "dk", "dv")):
            _close(g, w, what)

    def test_forward_saves_only_out_and_lse_beside_its_inputs(self):
        """What the autograd node keeps: q, k, v, the output and the f32
        logsumexp, (B, S, H); never a score block."""
        q, k, v, _ = _inputs(5)
        tq = torch.tensor(q, requires_grad=True)
        out = tca.chunked_attention(tq, torch.tensor(k), torch.tensor(v), True, None,
                                    BLOCK, BLOCK)
        saved = out.grad_fn.saved_tensors
        assert [tuple(t.shape) for t in saved] == [(B, S, H, HD), (B, S, K, HD),
                                                   (B, S, K, HD), (B, S, H, HD), (B, S, H)]
        assert saved[-1].dtype == torch.float32

    def test_output_keeps_the_query_dtype(self):
        q, k, v, _ = _inputs(6)
        out = tca.chunked_attention(*(torch.tensor(x).bfloat16() for x in (q, k, v)),
                                    True, None, BLOCK, BLOCK)
        assert out.dtype == torch.bfloat16

    def test_ragged_blocks_raise(self):
        q, k, v, _ = _inputs(7)
        with pytest.raises(ValueError, match="multiple of blocks"):
            tca.chunked_attention(*map(torch.tensor, (q, k, v)), True, None, 96, 96)


class TestRouting:
    @pytest.mark.parametrize("s", [2048, 2304, 2560, 2112, 2049])
    def test_block_choice_equals_reference(self, s, monkeypatch):
        """512 where S allows, else 256, 128, 64 or 1: the block the
        reference's ``ops.attention`` hands its chunked attention."""
        seen = {}

        def spy(q, k, v, causal, window, bq, bk):
            seen["block"] = (bq, bk)
            return q

        monkeypatch.setattr(jca, "chunked_attention", spy)
        x = jnp.zeros((1, s, 1, 8), jnp.float32)
        jops.attention(x, x, x, impl="auto")
        assert seen["block"] == (tops._chunked_block(s),) * 2

    def _spy(self, monkeypatch):
        calls = []
        real = tca.chunked_attention

        def spy(*a, **kw):
            calls.append(a[4:])
            return real(*a, **kw)

        monkeypatch.setattr(tops.ca, "chunked_attention", spy)
        return calls

    def test_cpu_self_attention_at_2048_takes_the_chunked_path(self, monkeypatch):
        calls = self._spy(monkeypatch)
        q, k, v, _ = _inputs(8, s=2048, h=2, k=1)
        q, k, v = map(torch.tensor, (q, k, v))
        out = tops.attention(q, k, v, causal=True, window=300)
        assert calls == [(300, 512, 512)]
        want = tref.attention(q, k, v, causal=True, window=300)
        assert (out - want).abs().max().item() <= TOL
        assert tops.attention(q, k, v, impl="chunked") is not None and len(calls) == 2

    @pytest.mark.parametrize("case", ["short", "cross", "bidirectional", "positions",
                                      "impl_ref"])
    def test_other_cpu_calls_stay_on_ref(self, case, monkeypatch):
        """2047 tokens, cross-attention (Sq != Skv), ``causal=False``, given
        positions, and an explicit ``impl="ref"`` take ``ref.attention``."""
        calls = self._spy(monkeypatch)
        s = 2047 if case == "short" else 2048
        q, k, v, _ = _inputs(9, s=s, h=2, k=1)
        q, k, v = map(torch.tensor, (q, k, v))
        kw = {}
        if case == "cross":
            k, v = k[:, :1024], v[:, :1024]
            kw["causal"] = False
        if case == "bidirectional":
            kw["causal"] = False
        if case == "positions":
            kw["q_positions"] = kw["kv_positions"] = torch.arange(s).expand(1, s)
        if case == "impl_ref":
            kw["impl"] = "ref"
        tops.attention(q, k, v, **kw)
        assert calls == []

    def test_meta_tensors_keep_the_flash_kernels(self, monkeypatch):
        """On the kernel path (CUDA and meta tensors) 2048 tokens still go
        to the flash kernels."""
        calls = self._spy(monkeypatch)
        seen = []
        monkeypatch.setattr(tops.fa, "flash_attention",
                            lambda q, k, v, causal, window: seen.append(q.device.type) or q)
        q = torch.empty(1, 2048, 2, 32, device="meta")
        k = torch.empty(1, 2048, 1, 32, device="meta")
        tops.attention(q, k, k)
        assert seen == ["meta"] and calls == []


class TestModelAt2048:
    def test_two_layer_g_model_logits_equal_reference(self, monkeypatch):
        """A reduced two-layer ``G`` model (qwen1.5-4b) at 2048 tokens: the
        port's logits (its CPU attention the chunked path) against the
        reference's ``forward``, which takes its own chunked path on the
        CPU; both from the reference's parameters."""
        calls = []
        real = tca.chunked_attention
        monkeypatch.setattr(tops.ca, "chunked_attention",
                            lambda *a: calls.append(1) or real(*a))
        over = dict(num_layers=2, d_model=64, num_heads=4, d_ff=128, vocab_size=256)
        jcfg = jax_get_config("qwen1.5-4b").reduced(**over)
        tcfg = torch_get_config("qwen1.5-4b").reduced(**over)
        jparams = jax.tree_util.tree_map(np.asarray, JT.init_lm(jcfg, jax.random.PRNGKey(0)))
        tokens = np.random.default_rng(10).integers(0, 256, (1, 2048)).astype(np.int32)
        want, _ = JT.forward(jcfg, jparams, jnp.asarray(tokens))
        got = TT.forward(tcfg, TT.from_reference(jparams), torch.from_numpy(tokens).long())
        assert len(calls) == 2
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert np.abs(got.detach().numpy() - want).max() <= 2e-4 * scale
