"""The flash-attention, RG-LRU and wkv6 kernels against their plain
versions on the card.

Imports no JAX, so it runs where the card is:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_on_card.py``.
Elsewhere every test skips: a CUDA kernel has no CPU mode.  Each kernel is
held on its own inputs (the backward kernels on the forward kernel's
logsumexp and delta) element by element: |got - want| <= rtol * |want| +
atol * rms(want), the limits of ``chip_smoke.py``.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rglru as rg
from repro_torch.kernels import wkv6 as wk

LIMITS = {torch.bfloat16: (1e-2, 1e-3), torch.float32: (2e-4, 2e-4)}

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_cuda():
    """Decided when each test runs, not at import: every worker collects
    the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _assert_close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    rtol, atol = LIMITS[got.dtype]
    g, w = got.float(), want.float()
    limit = rtol * w.abs() + atol * w.square().mean().sqrt()
    worst = float(((g - w).abs() / limit.clamp_min(1e-30)).max())
    assert torch.isfinite(g).all() and worst <= 1.0, f"{what}: {worst:.3f} of its limit"


def _inputs(S, H, K, hd, dtype):
    g = torch.Generator(device="cuda").manual_seed(0)
    return [torch.randn(2, S, n, hd, generator=g, device="cuda").to(dtype)
            for n in (H, K, K, H)]


class TestOnCard:
    @pytest.mark.parametrize("dtype,S,H,K,hd,window", [
        *((dt, *shape) for dt in (torch.float32, torch.bfloat16)
          for shape in ((300, 4, 2, 64, None), (512, 4, 1, 256, 100), (1024, 4, 4, 128, None))),
        # the bf16 tensor-core backward at hd 32 ragged, hd 64, hd 256 ragged with K > 1
        (torch.bfloat16, 300, 2, 1, 32, 32),
        (torch.bfloat16, 512, 4, 2, 64, 100),
        (torch.bfloat16, 1000, 8, 2, 256, None)])
    def test_kernels_vs_plain(self, dtype, S, H, K, hd, window):
        q, k, v, do = _inputs(S, H, K, hd, dtype)
        o, lse = fa.fwd(q, k, v, True, window)
        delta = fa.bwd_delta(o, do)
        dq = fa.bwd_dq(q, k, v, do, lse, delta, True, window)
        dk, dv = fa.bwd_dkdv(q, k, v, do, lse, delta, True, window)
        p_o, p_lse = fa.plain_fwd(q, k, v, True, window)
        p_dq, p_dk, p_dv = fa.plain_bwd(q, k, v, do, lse, delta, True, window)
        for what, got, want in (("o", o, p_o), ("lse", lse, p_lse),
                                ("delta", delta, fa.plain_bwd_delta(o, do)),
                                ("dq", dq, p_dq), ("dk", dk, p_dk), ("dv", dv, p_dv)):
            _assert_close(got, want, what)

    @pytest.mark.parametrize("S,H,K,hd,window", [(1024, 4, 4, 128, None),
                                                 (1000, 8, 2, 256, None),
                                                 (512, 10, 1, 256, 2048)])
    def test_backward_is_bitwise_deterministic(self, S, H, K, hd, window):
        """bf16 ``bwd_dq`` and ``bwd_dkdv`` twice: equal bits (no atomics;
        the group partials are summed in a fixed order)."""
        q, k, v, do = _inputs(S, H, K, hd, torch.bfloat16)
        o, lse = fa.fwd(q, k, v, True, window)
        delta = fa.bwd_delta(o, do)
        runs = [(fa.bwd_dq(q, k, v, do, lse, delta, True, window),
                 *fa.bwd_dkdv(q, k, v, do, lse, delta, True, window)) for _ in range(2)]
        for what, a, b in zip(("dq", "dk", "dv"), *runs):
            assert torch.equal(a, b), what

    @pytest.mark.parametrize("S,H,K,hd,window", [(1024, 4, 4, 128, None),
                                                 (1000, 8, 2, 256, None),
                                                 (512, 10, 1, 256, 2048),
                                                 (300, 2, 1, 32, 32)])
    def test_forward_is_bitwise_deterministic(self, S, H, K, hd, window):
        """bf16 ``fwd`` twice: equal o and lse (each written by one thread)."""
        q, k, v, _ = _inputs(S, H, K, hd, torch.bfloat16)
        (o1, lse1), (o2, lse2) = (fa.fwd(q, k, v, True, window) for _ in range(2))
        assert torch.equal(o1, o2) and torch.equal(lse1, lse2)

    def test_delta_raises_on_unaligned_rows(self):
        """``bwd_delta`` reads 16-byte chunks: a view that starts off a
        16-byte boundary raises, with no fallback."""
        _, _, _, do = _inputs(64, 2, 2, 64, torch.bfloat16)
        flat = torch.zeros(do.numel() + 1, dtype=torch.bfloat16, device="cuda")
        o = flat[1:].view(do.shape)
        with pytest.raises(ValueError, match="16-byte"):
            fa.bwd_delta(o, do)

    def test_fwd_raises_on_unaligned_rows(self):
        """The bf16 ``fwd`` copies q, k and v in 16-byte chunks: a view that
        starts off a 16-byte boundary raises, with no fallback."""
        q, k, v, _ = _inputs(64, 2, 2, 64, torch.bfloat16)
        flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device="cuda")
        q = flat[1:].view(q.shape)
        with pytest.raises(ValueError, match="16-byte"):
            fa.fwd(q, k, v, True, None)

    def test_ops_autograd_vs_ref_float32(self):
        """The differentiable path the model takes (``ops.attention`` on CUDA
        tensors) against autograd through ``ref.attention``, in float32,
        where the two differ only by summation order."""
        q, k, v, do = _inputs(384, 4, 2, 128, torch.float32)
        fa.reset_launches()
        outs = []
        for fn in (ops.attention, ref.attention):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = fn(*leaves, causal=True, window=200)
            outs.append([o.detach(), *torch.autograd.grad(o, leaves, do)])
        assert all(n == 1 for n in fa.LAUNCHES.values()), fa.LAUNCHES
        for what, got, want in zip(("o", "dq", "dk", "dv"), *outs):
            _assert_close(got, want, what)

    def test_unsupported_case_raises_on_the_card(self):
        q, k, v, _ = _inputs(64, 2, 2, 96, torch.float32)
        with pytest.raises(ValueError, match="head dim"):
            ops.attention(q, k, v)


def _rglru_inputs(B, S, W, dtype, r_shift=0.0):
    g = torch.Generator(device="cuda").manual_seed(1)
    x, r, i, dout = (torch.randn(B, S, W, generator=g, device="cuda") for _ in range(4))
    lam = torch.linspace(0.1, 2.0, W, device="cuda")
    h0 = torch.randn(B, W, generator=g, device="cuda")
    return x.to(dtype), (r + r_shift).to(dtype), i.to(dtype), lam, h0, dout.to(dtype)


class TestRGLRUOnCard:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("B,S,W,r_shift,with_h0", [(2, 1024, 256, 0.0, False),
                                                       (1, 1000, 200, 0.0, True),
                                                       (2, 64, 96, -40.0, True)])
    def test_kernels_vs_plain(self, dtype, B, S, W, r_shift, with_h0):
        x, r, i, lam, h0, dout = _rglru_inputs(B, S, W, dtype, r_shift)
        h0 = h0 if with_h0 else None
        dh_last = torch.randn_like(lam.expand(B, W).contiguous())
        out, h, states = rg.fwd(x, r, i, lam, h0, save_states=True)
        got = rg.bwd(x, r, i, lam, h0, states, dout, dh_last)
        p_out, p_h, p_states = rg.plain_fwd(x, r, i, lam, h0, save_states=True)
        want = rg.plain_bwd(x, r, i, lam, h0, states, dout, dh_last)
        for what, a, b in (("out", out, p_out), ("h", h, p_h), ("states", states, p_states),
                           *zip(("dx", "dr", "di", "dlam", "dh0"), got, want)):
            _assert_close(a, b, what)

    def test_ops_autograd_vs_ref_float32(self):
        x, r, i, lam, h0, dout = _rglru_inputs(2, 300, 160, torch.float32)
        rg.reset_launches()
        outs = []
        for impl in ("kernel", "ref"):
            leaves = [t.detach().requires_grad_() for t in (x, r, i, lam, h0)]
            out, h = ops.rglru(*leaves[:4], h0=leaves[4], impl=impl)
            outs.append([out.detach(), *torch.autograd.grad(out, leaves, dout)])
        assert rg.LAUNCHES == {"rglru_fwd": 1, "rglru_bwd": 1}, rg.LAUNCHES
        for what, got, want in zip(("out", "dx", "dr", "di", "dlam", "dh0"), *outs):
            _assert_close(got, want, what)

    def test_unsupported_case_raises_on_the_card(self):
        x, r, i, lam, _, _ = _rglru_inputs(1, 16, 32, torch.float32)
        with pytest.raises(ValueError, match="dtype"):
            ops.rglru(x.half(), r.half(), i.half(), lam)
        with pytest.raises(ValueError, match="lam"):
            ops.rglru(x, r, i, lam.to(torch.bfloat16))


def _wkv6_inputs(B, S, H, hd, dtype, strong=False):
    g = torch.Generator(device="cuda").manual_seed(2)
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    r, k, v, dout = 0.5 * mk(B, S, H, hd), 0.5 * mk(B, S, H, hd), mk(B, S, H, hd), \
        mk(B, S, H, hd)
    w = 1e-3 + 0.2 * torch.rand(B, S, H, hd, generator=g, device="cuda") if strong else \
        torch.exp(-torch.exp(mk(B, S, H, hd) - 3.0))
    u, s0, ds_last = 0.3 * mk(H, hd), mk(B, H, hd, hd), mk(B, H, hd, hd)
    return [t.to(dtype) for t in (r, k, v, w)] + [u, s0, dout.to(dtype), ds_last]


class TestWKV6OnCard:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("B,S,H,hd,strong,with_state", [(2, 256, 4, 64, False, False),
                                                            (1, 300, 2, 32, False, True),
                                                            (2, 130, 2, 64, True, True)])
    def test_kernels_vs_plain(self, dtype, B, S, H, hd, strong, with_state):
        r, k, v, w, u, s0, dout, ds_last = _wkv6_inputs(B, S, H, hd, dtype, strong)
        s0 = s0 if with_state else None
        out, s_last, ckpt = wk.fwd(r, k, v, w, u, s0, save_ckpt=True)
        got = wk.bwd(r, k, v, w, u, ckpt, dout, ds_last)
        p_out, p_s, p_ckpt = wk.plain_fwd(r, k, v, w, u, s0, save_ckpt=True)
        want = wk.plain_bwd(r, k, v, w, u, ckpt, dout, ds_last)
        for what, a, b in (("out", out, p_out), ("s_last", s_last, p_s), ("ckpt", ckpt, p_ckpt),
                           *zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want)):
            _assert_close(a, b, what)

    def test_ops_autograd_vs_ref_float32(self):
        r, k, v, w, u, s0, dout, _ = _wkv6_inputs(2, 200, 2, 64, torch.float32)
        wk.reset_launches()
        outs = []
        for impl in ("kernel", "ref"):
            leaves = [t.detach().requires_grad_() for t in (r, k, v, w, u, s0)]
            out, _ = ops.wkv6(*leaves[:5], state=leaves[5], impl=impl)
            outs.append([out.detach(), *torch.autograd.grad(out, leaves, dout)])
        assert wk.LAUNCHES == {"wkv6_fwd": 1, "wkv6_bwd": 1}, wk.LAUNCHES
        for what, got, want in zip(("out", "dr", "dk", "dv", "dw", "du", "ds0"), *outs):
            _assert_close(got, want, what)

    def test_unsupported_case_raises_on_the_card(self):
        r, k, v, w, u, _, _, _ = _wkv6_inputs(1, 16, 2, 64, torch.float32)
        with pytest.raises(ValueError, match="dtype"):
            ops.wkv6(r.half(), k.half(), v.half(), w.half(), u)
        with pytest.raises(ValueError, match="head dim"):
            ops.wkv6(*(t[..., :48].contiguous() for t in (r, k, v, w)), u[:, :48].contiguous())
