"""The flash-attention kernels against their plain versions on the card.

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

LIMITS = {torch.bfloat16: (1e-2, 1e-3), torch.float32: (2e-4, 2e-4)}

pytestmark = [pytest.mark.cuda, pytest.mark.skipif(
    not torch.cuda.is_available(), reason="needs a CUDA device: the kernels have no CPU mode")]


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
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("S,H,K,hd,window", [(300, 4, 2, 64, None),
                                                 (512, 4, 1, 256, 100),
                                                 (1024, 4, 4, 128, None)])
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
