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
        with pytest.raises(ValueError, match="pass no positions"):
            ops.attention(q, k, v, q_positions=pos, kv_positions=pos, impl="kernel")

    def test_cross_lengths_raise(self):
        """q and kv of different lengths: refused causal or windowed (the
        reference has no such cross-attention), taken bidirectional."""
        q, _, _ = _torch(_inputs(1, 32, 2, 2, 64), "float32")
        _, k, v = _torch(_inputs(1, 48, 2, 2, 64), "float32")
        with pytest.raises(ValueError, match="causal=False and no window"):
            fa.fwd(q, k, v)
        with pytest.raises(ValueError, match="causal=False and no window"):
            fa.fwd(q, k, v, causal=False, window=8)
        o, lse = fa.fwd(q, k, v, causal=False)
        assert o.shape == q.shape and lse.shape == (1, 2, 32)

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



# ----------------------------------------------------------------------
# The kernels bound as operators: shape functions and FLOP formulas
# ----------------------------------------------------------------------
def _fake(*shapes_dtypes, device="cuda"):
    """Fake tensors of (shape, dtype) on ``device`` (a new FakeTensorMode),
    and the mode."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode()
    with mode:
        return [torch.empty(s, dtype=d, device=device) for s, d in shapes_dtypes], mode


def _meta(tree):
    return [(tuple(t.shape), t.dtype) if t is not None else None
            for t in (tree if isinstance(tree, (tuple, list)) else (tree,))]


#: (B, S, H, K, hd, causal, window, Skv) of the flash shape-function checks:
#: GQA (where bfloat16 dk/dv are f32 partials), MHA, windowed and cross
FLASH_FAKE = [(2, 40, 4, 2, 64, True, None, 40), (1, 33, 3, 3, 32, True, 8, 33),
              (2, 17, 4, 1, 128, False, None, 29)]


class TestOperators:
    """Each kernel operator's shape function, under ``FakeTensorMode`` on
    ``cuda``, gives what the wrapper's plain version gives on the CPU
    (shapes and dtypes), launches nothing and loads no library; its FLOP
    formula gives ``kernels.cost``'s counts (``chip_smoke.py``'s bounds) at
    ``kernels.bench``'s shapes."""

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("B,S,H,K,hd,causal,window,Skv", FLASH_FAKE)
    def test_flash_shape_functions_match_plain(self, dtype, B, S, H, K, hd, causal, window,
                                               Skv):
        rng = np.random.default_rng(0)
        q = torch.from_numpy(rng.standard_normal((B, S, H, hd), np.float32)).to(dtype)
        k = torch.from_numpy(rng.standard_normal((B, Skv, K, hd), np.float32)).to(dtype)
        v = torch.from_numpy(rng.standard_normal((B, Skv, K, hd), np.float32)).to(dtype)
        o, lse, o32 = fa.fwd(q, k, v, causal, window, out_f32=True)
        delta = fa.bwd_delta(o32, o)
        want = [_meta((o, lse, o32)), _meta(delta),
                _meta(fa.bwd_dq(q, k, v, o, lse, delta, causal, window)),
                _meta(fa.bwd_dkdv(q, k, v, o, lse, delta, causal, window))]
        fa.reset_launches()
        (fq, fk, fv), mode = _fake(((B, S, H, hd), dtype), ((B, Skv, K, hd), dtype),
                                   ((B, Skv, K, hd), dtype))
        with mode:
            fo, flse, fo32 = fa.fwd(fq, fk, fv, causal, window, out_f32=True)
            fdelta = fa.bwd_delta(fo32, fo)
            got = [_meta((fo, flse, fo32)), _meta(fdelta),
                   _meta(fa.bwd_dq(fq, fk, fv, fo, flse, fdelta, causal, window)),
                   _meta(fa.bwd_dkdv(fq, fk, fv, fo, flse, fdelta, causal, window))]
            assert fo.is_cuda and type(fo).__name__ == "FakeTensor"
            # the operator itself: a bfloat16 GQA dk/dv is float32 partials per
            # query head, which the wrapper sums over each group
            dk_raw, _ = torch.ops.repro_torch.flash_bwd_dkdv(
                fq, fk, fv, fo, flse, fdelta, causal, window or 0)
        assert got == want
        partial = dtype == torch.bfloat16 and H != K
        assert (tuple(dk_raw.shape), dk_raw.dtype) == \
            (((B, Skv, H, hd), torch.float32) if partial else ((B, Skv, K, hd), dtype))
        assert all(n == 0 for n in fa.LAUNCHES.values()) and fa._lib is None

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_scan_shape_functions_match_plain(self, dtype):
        from repro_torch.kernels import rglru as rg
        from repro_torch.kernels import wkv6 as wk

        rng = np.random.default_rng(1)
        B, S, W, H, hd = 2, 70, 24, 2, 32

        def t(*shape, dt=dtype):
            return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dt)

        x, lam, h0 = t(B, S, W), t(W, dt=torch.float32), t(B, W, dt=torch.float32)
        r, w = t(B, S, H, hd), torch.rand(B, S, H, hd).to(dtype)
        u, st = t(H, hd, dt=torch.float32), t(B, H, hd, hd, dt=torch.float32)
        rg_out = rg.fwd(x, x, x, lam, h0, save_states=True)
        wk_out = wk.fwd(r, r, r, w, u, st, save_ckpt=True)
        want = [_meta(rg_out), _meta(rg.bwd(x, x, x, lam, h0, rg_out[2], x, h0)),
                _meta(wk_out), _meta(wk.bwd(r, r, r, w, u, wk_out[2], r, st))]
        rg.reset_launches()
        wk.reset_launches()
        (fx, flam, fh0, fr, fw, fu, fst), mode = _fake(
            ((B, S, W), dtype), ((W,), torch.float32), ((B, W), torch.float32),
            ((B, S, H, hd), dtype), ((B, S, H, hd), dtype), ((H, hd), torch.float32),
            ((B, H, hd, hd), torch.float32))
        with mode:
            frg = rg.fwd(fx, fx, fx, flam, fh0, save_states=True)
            fwk = wk.fwd(fr, fr, fr, fw, fu, fst, save_ckpt=True)
            got = [_meta(frg), _meta(rg.bwd(fx, fx, fx, flam, fh0, frg[2], fx, fh0)),
                   _meta(fwk), _meta(wk.bwd(fr, fr, fr, fw, fu, fwk[2], fr, fst))]
            assert rg.fwd(fx, fx, fx, flam)[2] is None and wk.fwd(fr, fr, fr, fw, fu)[2] is None
        assert got == want
        assert all(n == 0 for n in {**rg.LAUNCHES, **wk.LAUNCHES}.values())
        assert rg._lib is None and wk._lib is None

    def test_shape_functions_allocate_the_launches_scratch(self):
        """Under the dry run's byte count, a forward's peak is its outputs
        plus the scratch its launch allocates (the RG-LRU chunk buffer, the
        wkv6 ``dbuf``), and a meta tensor takes the same path."""
        from repro_torch.kernels import rglru as rg
        from repro_torch.kernels import wkv6 as wk
        from repro_torch.launch.dryrun import Lowering

        B, S, W, H, hd = 2, 200, 16, 2, 64
        (fx, flam, fr, fu), mode = _fake(((B, S, W), torch.bfloat16), ((W,), torch.float32),
                                         ((B, S, H, hd), torch.bfloat16),
                                         ((H, hd), torch.float32))
        nc_rg, nc_wk = rg.num_chunks(S), wk.num_checkpoints(S)
        with mode:
            with Lowering() as low:
                out = rg.fwd(fx, fx, fx, flam, save_states=True)
            assert low.peak == B * S * W * 2 + B * W * 4 + B * S * W * 4 \
                + 2 * (nc_rg - 1) * B * W * 4
            del out
            with Lowering() as low:
                out = wk.fwd(fr, fr, fr, fr, fu, save_ckpt=True)
            assert low.peak == B * S * H * hd * 2 + B * H * hd * hd * 4 \
                + B * H * nc_wk * hd * hd * 4 + B * H * nc_wk * hd * 4
        m = torch.empty(B, S, W, device="meta")
        assert rg.fwd(m, m, m, torch.empty(W, device="meta"))[0].is_meta

    def test_visible_pairs_equal_the_mask_count(self):
        from repro_torch.kernels import cost

        for S in (1, 2, 7, 64, 129):
            for window in (None, 1, 3, 64, 200):
                for causal in (True, False):
                    mask = fa._visible(S, S, causal, window, "cpu")
                    assert cost.visible_pairs(S, S, causal, window) == int(mask.sum())
        assert cost.visible_pairs(5, 9, False, None) == 45
        with pytest.raises(ValueError):
            cost.visible_pairs(5, 9, True, None)

    def test_flop_formulas_give_the_bounds_counts_at_the_bench_shapes(self):
        from torch.utils.flop_counter import FlopCounterMode

        from repro_torch.kernels import bench, cost
        from repro_torch.kernels import rglru as rg
        from repro_torch.kernels import wkv6 as wk

        shapes = [bench.SLICE, bench.L_BLOCK, bench.GEMMA3_L, bench.GEMMA3_G,
                  bench.INTERNLM2_G, bench.WHISPER_ENC, bench.WHISPER_DEC,
                  bench.WHISPER_CROSS, bench.LLAMA_G, bench.LLAMA_CROSS, bench.CROSS_DECODE]
        for shp in shapes:
            B, S, Skv, H, K, hd = (shp[k] for k in ("B", "S", "Skv", "H", "K", "hd"))
            causal, window, dt = shp["causal"], shp["window"], shp["dtype"]
            (q, k), mode = _fake(((B, S, H, hd), dt), ((B, Skv, K, hd), dt))
            with mode, FlopCounterMode(display=False) as fc:
                o, lse, o32 = fa.fwd(q, k, k, causal, window, out_f32=True)
                delta = fa.bwd_delta(o32, o)
                fa.bwd_dq(q, k, k, o, lse, delta, causal, window)
                fa.bwd_dkdv(q, k, k, o, lse, delta, causal, window)
            counts = {str(op).split(".")[-1]: n for op, n in fc.get_flop_counts()["Global"].items()}
            pairs = int(fa._visible(S, Skv, causal, window, "cpu").sum()) * B * H
            want = {"flash_fwd": 4 * pairs * hd, "flash_bwd_delta": 2 * B * S * H * hd,
                    "flash_bwd_dq": 6 * pairs * hd, "flash_bwd_dkdv": 8 * pairs * hd}
            assert counts == want, shp
            assert {n: int(f) for n, f in cost.flash_flops(
                B, S, Skv, H, hd, causal, window).items()} == want
        B, S, W = (bench.RGLRU_SLICE[k] for k in ("B", "S", "W"))
        (x, lam), mode = _fake(((B, S, W), torch.bfloat16), ((W,), torch.float32))
        with mode, FlopCounterMode(display=False) as fc:
            _, _, states = rg.fwd(x, x, x, lam, save_states=True)
            rg.bwd(x, x, x, lam, None, states, x)
        assert {str(op).split(".")[-1]: n for op, n in fc.get_flop_counts()["Global"].items()} \
            == {"rglru_fwd": 8 * B * S * W, "rglru_bwd": 16 * B * S * W}
        B, S, H, hd = (bench.WKV6_SLICE[k] for k in ("B", "S", "H", "hd"))
        (r, u), mode = _fake(((B, S, H, hd), torch.bfloat16), ((H, hd), torch.float32))
        with mode, FlopCounterMode(display=False) as fc:
            _, _, ckpt = wk.fwd(r, r, r, r, u, save_ckpt=True)
            wk.bwd(r, r, r, r, u, ckpt, r)
        assert {str(op).split(".")[-1]: n for op, n in fc.get_flop_counts()["Global"].items()} \
            == {"wkv6_fwd": 4 * B * S * H * hd * hd, "wkv6_bwd": 8 * B * S * H * hd * hd}
