"""The port's attention against the reference's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both sides.
Forward: ``repro_torch.kernels.ops.attention`` against the Pallas kernel
in interpret mode and ``repro.kernels.ref.attention`` (tolerances of
``tests/test_kernels.py``: 2e-4 f32, 3e-2 bf16).  Backward: the kernels'
decomposition (``FlashAttention`` running the kernels' plain versions on
CPU tensors: delta, dq, dk/dv from the saved logsumexp) and autograd
through the port's ref, against ``jax.grad`` of the reference's ref, in
f32 to 1e-4 of the gradient's scale (sums over at most 512 keys).  The
kernels themselves run only on the card (``tests/test_torch_on_card.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

GRAD_TOL = 1e-4


def _tol(dtype):
    return 3e-2 if dtype == "bfloat16" else 2e-4


def _inputs(B, S, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), np.float32),
            rng.standard_normal((B, S, K, hd), np.float32),
            rng.standard_normal((B, S, K, hd), np.float32))


def _jax(arrs, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


class TestForward:
    @pytest.mark.parametrize("B,S,H,K,hd,bq,bk", [
        (2, 256, 4, 2, 64, 128, 128),
        (1, 256, 4, 1, 128, 64, 64),
        (1, 128, 8, 8, 64, 128, 32),
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_causal_sweep_vs_pallas_and_ref(self, B, S, H, K, hd, bq, bk, dtype):
        arrs = _inputs(B, S, H, K, hd)
        want_pallas = pallas_flash(*_jax(arrs, dtype), causal=True, block_q=bq,
                                   block_k=bk, interpret=True)
        want_ref = jref.attention(*_jax(arrs, dtype), causal=True)
        for impl in ("ref", "kernel"):
            got = ops.attention(*_torch(arrs, dtype), causal=True, impl=impl)
            assert got.dtype == getattr(torch, dtype)
            assert tuple(got.shape) == want_ref.shape
            assert _err(_np(got), want_pallas.astype(jnp.float32)) < _tol(dtype)
            assert _err(_np(got), want_ref.astype(jnp.float32)) < _tol(dtype)

    @pytest.mark.parametrize("window", [32, 100, 511])
    def test_sliding_window_vs_pallas(self, window):
        arrs = _inputs(1, 512, 4, 2, 64, seed=1)
        want = pallas_flash(*_jax(arrs, "float32"), causal=True, window=window,
                            block_q=128, block_k=128, interpret=True)
        for impl in ("ref", "kernel"):
            got = ops.attention(*_torch(arrs, "float32"), causal=True, window=window,
                                impl=impl)
            assert _err(_np(got), want) < 2e-4

    @pytest.mark.parametrize("window", [None, 40])
    def test_ragged_sequence_vs_ref(self, window):
        """S = 100 is no multiple of any tile; the Pallas kernel rejects it,
        the port masks the tail."""
        arrs = _inputs(2, 100, 4, 2, 32, seed=2)
        want = jref.attention(*_jax(arrs, "float32"), causal=True, window=window)
        for impl in ("ref", "kernel"):
            got = ops.attention(*_torch(arrs, "float32"), causal=True, window=window,
                                impl=impl)
            assert _err(_np(got), want) < 2e-4

    def test_positions_vs_ref(self):
        """The port's ref takes explicit (shifted) positions like the
        reference's."""
        arrs = _inputs(2, 64, 4, 2, 32, seed=3)
        pos = np.broadcast_to(np.arange(64) + 7, (2, 64)).astype(np.int32)
        want = jref.attention(*_jax(arrs, "float32"), q_positions=jnp.asarray(pos),
                              kv_positions=jnp.asarray(pos), causal=True, window=16)
        got = ops.attention(*_torch(arrs, "float32"), q_positions=torch.from_numpy(pos),
                            kv_positions=torch.from_numpy(pos), causal=True, window=16,
                            impl="ref")
        assert _err(_np(got), want) < 2e-4

    def test_lse_matches_logsumexp_of_scores(self):
        arrs = _inputs(1, 96, 2, 1, 64, seed=4)
        q, k, v = _torch(arrs, "float32")
        _, lse = fa.fwd(q, k, v, True, None)
        s = torch.einsum("bqhd,bkhd->bhqk", q, tref.repeat_kv(k, 2)) / 8.0
        s = s.masked_fill(~torch.ones(96, 96, dtype=torch.bool).tril(), -1e30)
        assert torch.allclose(lse, torch.logsumexp(s, dim=-1), atol=1e-5)


class TestBackward:
    @pytest.mark.parametrize("B,S,H,K,hd,window", [
        (1, 128, 4, 2, 64, None),
        (2, 100, 4, 1, 32, None),
        (1, 256, 2, 2, 64, 48),
    ])
    def test_grads_vs_jax_grad_of_ref(self, B, S, H, K, hd, window):
        arrs = _inputs(B, S, H, K, hd, seed=5)
        cot = np.random.default_rng(6).standard_normal((B, S, H, hd), np.float32)

        def f(q, k, v):
            return jnp.sum(jref.attention(q, k, v, causal=True, window=window)
                           * jnp.asarray(cot))

        want = jax.grad(f, argnums=(0, 1, 2))(*_jax(arrs, "float32"))
        for impl in ("ref", "kernel"):
            ts = [t.requires_grad_() for t in _torch(arrs, "float32")]
            out = ops.attention(*ts, causal=True, window=window, impl=impl)
            got = torch.autograd.grad(out, ts, torch.from_numpy(cot))
            for g, w in zip(got, want):
                w = np.asarray(w)
                assert _err(_np(g), w) <= GRAD_TOL * max(1.0, float(np.abs(w).max()))

    def test_plain_pieces_compose_to_autograd_of_plain_fwd(self):
        """delta and the plain backward equal autograd through the plain
        forward (the definition the kernels are held to on the card)."""
        arrs = _inputs(1, 80, 4, 2, 32, seed=7)
        q, k, v = [t.double().float().requires_grad_() for t in _torch(arrs, "float32")]
        do = torch.randn(1, 80, 4, 32, generator=torch.Generator().manual_seed(0))
        o, lse = fa.plain_fwd(q, k, v, True, 24)
        want = torch.autograd.grad(o, (q, k, v), do)
        delta = fa.plain_bwd_delta(o.detach(), do)
        got = fa.plain_bwd(q.detach(), k.detach(), v.detach(), do, lse.detach(), delta,
                           True, 24)
        for g, w in zip(got, want):
            assert torch.allclose(g, w, atol=1e-5)


class TestDispatchAndChecks:
    def test_auto_is_ref_on_cpu(self):
        q, k, v = _torch(_inputs(1, 64, 2, 2, 64), "float32")
        fa.reset_launches()
        out = ops.attention(q, k, v)
        assert torch.equal(out, tref.attention(q, k, v))
        assert all(n == 0 for n in fa.LAUNCHES.values())

    def test_cpu_wrappers_count_no_launches(self):
        q, k, v = _torch(_inputs(1, 64, 2, 2, 64), "float32")
        fa.reset_launches()
        q.requires_grad_()
        out = ops.attention(q, k, v, impl="kernel")
        out.sum().backward()
        assert all(n == 0 for n in fa.LAUNCHES.values())

    @pytest.mark.parametrize("hd", [48, 96, 512])
    def test_unsupported_head_dim_raises(self, hd):
        q, k, v = _torch(_inputs(1, 32, 2, 2, hd), "float32")
        with pytest.raises(ValueError, match="head dim"):
            ops.attention(q, k, v, impl="kernel")

    def test_positions_raise_on_kernel_path(self):
        q, k, v = _torch(_inputs(1, 32, 2, 2, 64), "float32")
        pos = torch.arange(32)[None]
        with pytest.raises(ValueError, match="aligned"):
            ops.attention(q, k, v, q_positions=pos, kv_positions=pos, impl="kernel")

    def test_cross_lengths_raise(self):
        q, _, _ = _torch(_inputs(1, 32, 2, 2, 64), "float32")
        _, k, v = _torch(_inputs(1, 48, 2, 2, 64), "float32")
        with pytest.raises(ValueError, match="aligned"):
            fa.fwd(q, k, v)

    def test_bad_dtype_and_layout_raise(self):
        q, k, v = _torch(_inputs(1, 32, 2, 2, 64), "float32")
        with pytest.raises(ValueError, match="dtype"):
            fa.fwd(q.half(), k.half(), v.half())
        with pytest.raises(ValueError, match="contiguous"):
            fa.fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
        with pytest.raises(ValueError, match="one dtype"):
            fa.fwd(q, k.to(torch.bfloat16), v)

    @pytest.mark.parametrize("hd", [48, 96, 512])
    def test_delta_unsupported_head_dim_raises(self, hd):
        o = torch.zeros(1, 8, 2, hd)
        with pytest.raises(ValueError, match="head dim"):
            fa.bwd_delta(o, o)

    @pytest.mark.parametrize("kernel,hd", [("flash_bwd_delta", 128), ("flash_fwd", 96)])
    def test_occupancy_rejects_what_has_no_tensor_core_kernel(self, kernel, hd):
        """Checked before the library is built or loaded."""
        with pytest.raises(ValueError, match="kernel must be|head dim"):
            fa.occupancy(kernel, hd)
        assert fa._lib is None

    def test_unknown_impl_raises(self):
        q, k, v = _torch(_inputs(1, 32, 2, 2, 64), "float32")
        with pytest.raises(ValueError, match="impl"):
            ops.attention(q, k, v, impl="pallas")

    def test_importing_builds_nothing(self):
        assert fa._lib is None

