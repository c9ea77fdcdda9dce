"""The flash-attention, RG-LRU and wkv6 kernels against their plain
versions on the card (the scans also at one token with a carried state, as
in decode), the decode path against the forward pass, and the paper's CNNs
on the card against the CPU.

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
        (torch.bfloat16, 1000, 8, 2, 256, None),
        # gemma3-1b's main-path shapes: L blocks (window 512 < S) and G blocks
        pytest.param(torch.bfloat16, 1024, 4, 1, 256, 512, id="gemma3_l"),
        pytest.param(torch.bfloat16, 1024, 4, 1, 256, None, id="gemma3_g"),
        # the G blocks of internlm2-20b and grok-1-314b (a group of 6 query
        # heads per kv head), qwen1.5-32b and qwen2-moe-a2.7b
        pytest.param(torch.bfloat16, 1024, 48, 8, 128, None, id="internlm2_g"),
        pytest.param(torch.bfloat16, 1024, 40, 40, 128, None, id="qwen32_g"),
        pytest.param(torch.bfloat16, 1024, 16, 16, 128, None, id="qwen2moe_g")])
    def test_kernels_vs_plain(self, dtype, S, H, K, hd, window):
        q, k, v, do = _inputs(S, H, K, hd, dtype)
        o, lse, o32 = fa.fwd(q, k, v, True, window, out_f32=True)
        delta = fa.bwd_delta(o32, do)
        dq = fa.bwd_dq(q, k, v, do, lse, delta, True, window)
        dk, dv = fa.bwd_dkdv(q, k, v, do, lse, delta, True, window)
        p_o, p_lse, p_o32 = fa.plain_fwd(q, k, v, True, window, out_f32=True)
        p_dq, p_dk, p_dv = fa.plain_bwd(q, k, v, do, lse, delta, True, window)
        for what, got, want in (("o", o, p_o), ("lse", lse, p_lse), ("o32", o32, p_o32),
                                ("delta", delta, fa.plain_bwd_delta(o32, do)),
                                ("dq", dq, p_dq), ("dk", dk, p_dk), ("dv", dv, p_dv)):
            _assert_close(got, want, what)

    @pytest.mark.parametrize("S,H,K,hd,window", [(1024, 4, 4, 128, None),
                                                 (1000, 8, 2, 256, None),
                                                 (512, 10, 1, 256, 2048),
                                                 pytest.param(1024, 4, 1, 256, 512,
                                                              id="gemma3_l"),
                                                 pytest.param(1024, 48, 8, 128, None,
                                                              id="internlm2_g")])
    def test_backward_is_bitwise_deterministic(self, S, H, K, hd, window):
        """bf16 ``bwd_dq`` and ``bwd_dkdv`` twice: equal bits (no atomics;
        the group partials are summed in a fixed order)."""
        q, k, v, do = _inputs(S, H, K, hd, torch.bfloat16)
        _, lse, o32 = fa.fwd(q, k, v, True, window, out_f32=True)
        delta = fa.bwd_delta(o32, do)
        runs = [(fa.bwd_dq(q, k, v, do, lse, delta, True, window),
                 *fa.bwd_dkdv(q, k, v, do, lse, delta, True, window)) for _ in range(2)]
        for what, a, b in zip(("dq", "dk", "dv"), *runs):
            assert torch.equal(a, b), what

    @pytest.mark.parametrize("S,H,K,hd,window", [(1024, 4, 4, 128, None),
                                                 (1000, 8, 2, 256, None),
                                                 (512, 10, 1, 256, 2048),
                                                 (300, 2, 1, 32, 32),
                                                 pytest.param(1024, 4, 1, 256, 512,
                                                              id="gemma3_l"),
                                                 pytest.param(1024, 48, 8, 128, None,
                                                              id="internlm2_g")])
    def test_forward_is_bitwise_deterministic(self, S, H, K, hd, window):
        """bf16 ``fwd`` twice: equal o and lse (each written by one thread)."""
        q, k, v, _ = _inputs(S, H, K, hd, torch.bfloat16)
        (o1, lse1), (o2, lse2) = (fa.fwd(q, k, v, True, window) for _ in range(2))
        assert torch.equal(o1, o2) and torch.equal(lse1, lse2)

    def test_delta_raises_on_unaligned_rows(self):
        """``bwd_delta`` reads 16-byte chunks: a view that starts off a
        16-byte boundary raises, with no fallback."""
        _, _, _, do = _inputs(64, 2, 2, 64, torch.bfloat16)
        flat = torch.zeros(do.numel() + 1, dtype=torch.float32, device="cuda")
        o32 = flat[1:].view(do.shape)
        with pytest.raises(ValueError, match="16-byte"):
            fa.bwd_delta(o32, do)

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

    @pytest.mark.parametrize("dtype,B,Sq,Skv,H,K,hd,causal", [
        # chip_smoke.py's encoder-decoder shapes: whisper-tiny's encoder
        # (bidirectional, ragged at 1500), decoder and cross-attention,
        # llama-3.2-vision-90b's G blocks and cross-attention (a group of 8)
        pytest.param(torch.bfloat16, 8, 1500, 1500, 6, 6, 64, False, id="whisper_enc"),
        pytest.param(torch.bfloat16, 8, 448, 448, 6, 6, 64, True, id="whisper_dec"),
        pytest.param(torch.bfloat16, 8, 448, 1500, 6, 6, 64, False, id="whisper_cross"),
        pytest.param(torch.bfloat16, 1, 4096, 4096, 64, 8, 128, True, id="llama_g"),
        pytest.param(torch.bfloat16, 1, 4096, 1601, 64, 8, 128, False, id="llama_cross"),
        pytest.param(torch.bfloat16, 4, 1, 1601, 64, 8, 128, False, id="cross_decode"),
        pytest.param(torch.float32, 2, 100, 300, 4, 2, 64, False, id="f32_cross_ragged"),
        pytest.param(torch.float32, 1, 1000, 1000, 4, 4, 32, False, id="f32_noncausal"),
        # every head dim, fewer kv rows than q rows, one query row
        *(pytest.param(dt, 2, sq, skv, 4, 2, hd, False, id=f"{str(dt)[6:]}_{sq}x{skv}_hd{hd}")
          for dt in (torch.float32, torch.bfloat16) for hd in (32, 64, 128, 256)
          for sq, skv in ((70, 19), (1, 130)))])
    def test_bidirectional_and_cross_kernels_vs_plain(self, dtype, B, Sq, Skv, H, K, hd,
                                                      causal):
        """q and kv of different lengths (no mask) and bidirectional
        attention: every kernel against its plain version, as
        ``test_kernels_vs_plain``."""
        g = torch.Generator(device="cuda").manual_seed(0)
        q, do = (torch.randn(B, Sq, H, hd, generator=g, device="cuda").to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(B, Skv, K, hd, generator=g, device="cuda").to(dtype)
                for _ in range(2))
        o, lse, o32 = fa.fwd(q, k, v, causal, None, out_f32=True)
        delta = fa.bwd_delta(o32, do)
        dq = fa.bwd_dq(q, k, v, do, lse, delta, causal, None)
        dk, dv = fa.bwd_dkdv(q, k, v, do, lse, delta, causal, None)
        p_o, p_lse, p_o32 = fa.plain_fwd(q, k, v, causal, None, out_f32=True)
        p_dq, p_dk, p_dv = fa.plain_bwd(q, k, v, do, lse, delta, causal, None)
        for what, got, want in (("o", o, p_o), ("lse", lse, p_lse), ("o32", o32, p_o32),
                                ("delta", delta, fa.plain_bwd_delta(o32, do)),
                                ("dq", dq, p_dq), ("dk", dk, p_dk), ("dv", dv, p_dv)):
            _assert_close(got, want, what)

    def test_long_causal_autograd_vs_ref_bfloat16(self):
        """4096 causal tokens, a GQA group of 8, bfloat16: autograd through
        the kernels against autograd through ``ref.attention`` in float32,
        within chip_smoke.py's AUTOGRAD_BF16_LIMIT (1e-2, 1e-1 rms).  Its
        delta reads the forward's float32 output: from the output rounded
        to bfloat16, dq's short rows read 1.41 of that limit."""
        g = torch.Generator(device="cuda").manual_seed(2)
        q, do = (torch.randn(1, 4096, 8, 128, generator=g, device="cuda").bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(1, 4096, 1, 128, generator=g, device="cuda").bfloat16()
                for _ in range(2))
        outs = []
        for fn, ins in ((fa.flash_attention, (q, k, v, do)),
                        (ref.attention, [t.float() for t in (q, k, v, do)])):
            leaves = [t.detach().requires_grad_() for t in ins[:3]]
            o = fn(*leaves, causal=True)
            outs.append([o.detach(), *torch.autograd.grad(o, leaves, ins[3])])
        for what, got, want in zip(("o", "dq", "dk", "dv"), *outs):
            w = want.float()
            limit = 1e-2 * w.abs() + 1e-1 * w.square().mean().sqrt()
            worst = float(((got.float() - w).abs() / limit).max())
            assert worst <= 1.0, f"{what}: {worst:.3f} of its limit"

    def test_cross_attention_autograd_vs_ref_float32(self):
        """``ops.attention`` at Sq != Skv (no mask) against autograd through
        ``ref.attention`` in float32; a causal one raises."""
        g = torch.Generator(device="cuda").manual_seed(1)
        q, do = (torch.randn(2, 50, 4, 64, generator=g, device="cuda") for _ in range(2))
        k, v = (torch.randn(2, 170, 2, 64, generator=g, device="cuda") for _ in range(2))
        outs = []
        for fn in (ops.attention, ref.attention):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = fn(*leaves, causal=False)
            outs.append([o.detach(), *torch.autograd.grad(o, leaves, do)])
        for what, got, want in zip(("o", "dq", "dk", "dv"), *outs):
            _assert_close(got, want, what)
        with pytest.raises(ValueError, match="causal=False and no window"):
            ops.attention(q, k, v, causal=True)


def _rglru_inputs(B, S, W, dtype, r_shift=0.0, lam=None):
    """``lam``: that value in every lane (20: the chunks' decay products
    underflow to 0), else linspace(0.1, 2, W)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    x, r, i, dout = (torch.randn(B, S, W, generator=g, device="cuda") for _ in range(4))
    lam = torch.linspace(0.1, 2.0, W, device="cuda") if lam is None else \
        torch.full((W,), float(lam), device="cuda")
    h0 = torch.randn(B, W, generator=g, device="cuda")
    return x.to(dtype), (r + r_shift).to(dtype), i.to(dtype), lam, h0, dout.to(dtype)


class TestRGLRUOnCard:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("B,S,W,r_shift,with_h0,lam", [
        (2, 1024, 256, 0.0, False, None),
        (1, 1000, 200, 0.0, True, None),
        (2, 64, 96, -40.0, True, None),
        # the chunked scan's edges: ragged last chunks (S 65, 1000) at an
        # odd width (the one-lane kernels), one step, and decay products
        # that underflow to exactly 0
        (2, 65, 77, 0.0, True, None),
        (1, 1, 64, 0.0, True, None),
        (2, 1000, 130, 0.0, True, 20.0),
        (2, 300, 33, 0.0, False, 20.0)])
    def test_kernels_vs_plain(self, dtype, B, S, W, r_shift, with_h0, lam):
        x, r, i, lam, h0, dout = _rglru_inputs(B, S, W, dtype, r_shift, lam)
        h0 = h0 if with_h0 else None
        dh_last = torch.randn_like(lam.expand(B, W).contiguous())
        out, h, states = rg.fwd(x, r, i, lam, h0, save_states=True)
        got = rg.bwd(x, r, i, lam, h0, states, dout, dh_last)
        p_out, p_h, p_states = rg.plain_fwd(x, r, i, lam, h0, save_states=True)
        want = rg.plain_bwd(x, r, i, lam, h0, states, dout, dh_last)
        for what, a, b in (("out", out, p_out), ("h", h, p_h), ("states", states, p_states),
                           *zip(("dx", "dr", "di", "dlam", "dh0"), got, want)):
            _assert_close(a, b, what)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("S,W", [(1024, 2560), (300, 77)])
    def test_forward_and_backward_are_bitwise_deterministic(self, dtype, S, W):
        """Twice on the same inputs: equal bits in every output (no atomics;
        dlam's per-chunk partials are summed in a fixed order)."""
        x, r, i, lam, h0, dout = _rglru_inputs(2, S, W, dtype)
        dh_last = torch.randn_like(h0)
        runs = []
        for _ in range(2):
            out, h, states = rg.fwd(x, r, i, lam, h0, save_states=True)
            runs.append((out, h, states, *rg.bwd(x, r, i, lam, h0, states, dout, dh_last)))
        for what, a, b in zip(("out", "h", "states", "dx", "dr", "di", "dlam", "dh0"), *runs):
            assert torch.equal(a, b), what

    def test_build_has_no_spill(self):
        """``-Xptxas -v`` reports no spill for any RG-LRU kernel."""
        import re

        from repro_torch.kernels.build import library_path

        rg.load_library()
        log = library_path(rg.SOURCE).with_suffix(".log").read_text()
        assert "rglru" in log
        assert not any(int(n) for n in re.findall(r"(\d+) bytes spill", log)), log[-2000:]

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

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_one_token_with_a_carried_state(self, dtype):
        """Decode: S = 1 with h0 at batch 4 and recurrentgemma-2b's width,
        through ``ops`` under ``no_grad``, against the plain version; then 8
        tokens one at a time, carrying h, against one call over the 8."""
        x, r, i, lam, h0, _ = _rglru_inputs(4, 8, 2560, dtype)
        rg.reset_launches()
        with torch.no_grad():
            out, h = ops.rglru(x[:, :1], r[:, :1], i[:, :1], lam, h0=h0)
            p_out, p_h, _ = rg.plain_fwd(x[:, :1], r[:, :1], i[:, :1], lam, h0)
            steps, carried = [], h0
            for t in range(8):
                o, carried = ops.rglru(x[:, t:t + 1], r[:, t:t + 1], i[:, t:t + 1], lam,
                                       h0=carried)
                steps.append(o)
            whole, h_whole = ops.rglru(x, r, i, lam, h0=h0)
        assert rg.LAUNCHES == {"rglru_fwd": 10, "rglru_bwd": 0}, rg.LAUNCHES
        _assert_close(out, p_out, "out")
        _assert_close(h, p_h, "h")
        _assert_close(torch.cat(steps, 1), whole, "one token at a time")
        _assert_close(carried, h_whole, "carried h")

    def test_unsupported_case_raises_on_the_card(self):
        x, r, i, lam, _, _ = _rglru_inputs(1, 16, 32, torch.float32)
        with pytest.raises(ValueError, match="dtype"):
            ops.rglru(x.half(), r.half(), i.half(), lam)
        with pytest.raises(ValueError, match="lam"):
            ops.rglru(x, r, i, lam.to(torch.bfloat16))


def _wkv6_inputs(B, S, H, hd, dtype, strong=False, zeros=False):
    """``zeros``: a quarter of the strong decays set to exactly 0."""
    g = torch.Generator(device="cuda").manual_seed(2)
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    r, k, v, dout = 0.5 * mk(B, S, H, hd), 0.5 * mk(B, S, H, hd), mk(B, S, H, hd), \
        mk(B, S, H, hd)
    w = 1e-3 + 0.2 * torch.rand(B, S, H, hd, generator=g, device="cuda") if strong else \
        torch.exp(-torch.exp(mk(B, S, H, hd) - 3.0))
    if zeros:
        w = w.masked_fill(torch.rand(w.shape, generator=g, device="cuda") < 0.25, 0.0)
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

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("S,hd", [(1, 64), (7, 32), (64, 64), (65, 32)])
    def test_short_sequences_vs_plain(self, dtype, S, hd):
        """S below a 16-step tile, one whole 64-step chunk, and one step
        past it, with a carried state."""
        r, k, v, w, u, s0, dout, ds_last = _wkv6_inputs(2, S, 2, hd, dtype)
        out, s_last, ckpt = wk.fwd(r, k, v, w, u, s0, save_ckpt=True)
        got = wk.bwd(r, k, v, w, u, ckpt, dout, ds_last)
        p_out, p_s, p_ckpt = wk.plain_fwd(r, k, v, w, u, s0, save_ckpt=True)
        want = wk.plain_bwd(r, k, v, w, u, ckpt, dout, ds_last)
        for what, a, b in (("out", out, p_out), ("s_last", s_last, p_s), ("ckpt", ckpt, p_ckpt),
                           *zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want)):
            _assert_close(a, b, what)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("S,hd", [(1000, 32), (130, 64)])
    def test_zero_decay_vs_plain(self, dtype, S, hd):
        """w = 0 in a quarter of the entries: the chunks' decay products are
        exactly 0 there, and nothing divides by w."""
        r, k, v, w, u, s0, dout, ds_last = _wkv6_inputs(2, S, 2, hd, dtype, strong=True,
                                                        zeros=True)
        assert bool((w == 0).any())
        out, s_last, ckpt = wk.fwd(r, k, v, w, u, s0, save_ckpt=True)
        got = wk.bwd(r, k, v, w, u, ckpt, dout, ds_last)
        p_out, p_s, p_ckpt = wk.plain_fwd(r, k, v, w, u, s0, save_ckpt=True)
        want = wk.plain_bwd(r, k, v, w, u, ckpt, dout, ds_last)
        for what, a, b in (("out", out, p_out), ("s_last", s_last, p_s), ("ckpt", ckpt, p_ckpt),
                           *zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want)):
            _assert_close(a, b, what)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("S,hd", [(1024, 64), (300, 32)])
    def test_forward_and_backward_are_bitwise_deterministic(self, dtype, S, hd):
        """Twice on the same inputs: equal bits in every output (no atomics;
        the sums over column groups and over chunks run in a fixed order)."""
        r, k, v, w, u, s0, dout, ds_last = _wkv6_inputs(2, S, 4, hd, dtype)
        runs = []
        for _ in range(2):
            out, s_last, ckpt = wk.fwd(r, k, v, w, u, s0, save_ckpt=True)
            runs.append((out, s_last, ckpt, *wk.bwd(r, k, v, w, u, ckpt, dout, ds_last)))
        for what, a, b in zip(("out", "s_last", "ckpt", "dr", "dk", "dv", "dw", "du", "ds0"),
                              *runs):
            assert torch.equal(a, b), what

    def test_build_has_no_spill(self):
        """``-Xptxas -v`` reports no spill for any wkv6 kernel."""
        import re

        from repro_torch.kernels.build import library_path

        wk.load_library()
        log = library_path(wk.SOURCE).with_suffix(".log").read_text()
        assert "wkv6" in log
        assert not any(int(n) for n in re.findall(r"(\d+) bytes spill", log)), log[-2000:]

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

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_one_token_with_a_carried_state(self, dtype):
        """Decode: S = 1 with a state at batch 4 and rwkv6-1.6b's 32 heads of
        64, through ``ops`` under ``no_grad``, against the plain version;
        then 8 tokens one at a time, carrying the state, against one call
        over the 8."""
        r, k, v, w, u, s0, _, _ = _wkv6_inputs(4, 8, 32, 64, dtype)
        wk.reset_launches()
        with torch.no_grad():
            first = [t[:, :1] for t in (r, k, v, w)]
            out, s1 = ops.wkv6(*first, u, state=s0)
            p_out, p_s, _ = wk.plain_fwd(*first, u, s0)
            steps, carried = [], s0
            for t in range(8):
                o, carried = ops.wkv6(*(x[:, t:t + 1] for x in (r, k, v, w)), u,
                                      state=carried)
                steps.append(o)
            whole, s_whole = ops.wkv6(r, k, v, w, u, state=s0)
        assert wk.LAUNCHES == {"wkv6_fwd": 10, "wkv6_bwd": 0}, wk.LAUNCHES
        _assert_close(out, p_out, "out")
        _assert_close(s1, p_s, "state")
        _assert_close(torch.cat(steps, 1), whole, "one token at a time")
        _assert_close(carried, s_whole, "carried state")

    def test_unsupported_case_raises_on_the_card(self):
        r, k, v, w, u, _, _, _ = _wkv6_inputs(1, 16, 2, 64, torch.float32)
        with pytest.raises(ValueError, match="dtype"):
            ops.wkv6(r.half(), k.half(), v.half(), w.half(), u)
        with pytest.raises(ValueError, match="head dim"):
            ops.wkv6(*(t[..., :48].contiguous() for t in (r, k, v, w)), u[:, :48].contiguous())


class TestDecodeOnCard:
    @pytest.mark.parametrize("arch", ["qwen1.5-4b", "recurrentgemma-2b", "rwkv6-1.6b",
                                      "gemma3-1b"])
    def test_decode_equals_forward(self, arch):
        """A reduced model (float32, TF32 off) decoded token by token through
        the caches, the scans at one token and a 16-slot ring buffer that 40
        tokens wrap, against ``forward`` over the same tokens (flash and
        full-sequence scans) within 2e-4 of the logits' scale; the scans'
        forward kernels launch once a token and layer."""
        import dataclasses

        from repro_torch import kernels
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T
        from repro_torch.traces.generate import tf32

        cfg = get_config(arch).reduced(num_layers=3 if arch == "recurrentgemma-2b" else 2)
        if cfg.sliding_window:
            cfg = dataclasses.replace(cfg, sliding_window=16)
        params = T.init_lm(cfg, seed=0, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(0)
        tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=g, device="cuda")
        kernels.reset_launches()
        with tf32(False):
            decoded, _ = T.prefill_via_decode(cfg, params, tokens, 40)
            launched = kernels.all_launches()
            with torch.no_grad():
                full = T.forward(cfg, params, tokens)
        scale = float(full.abs().max())
        assert float((decoded - full).abs().max()) <= 2e-4 * scale
        for kind, name in (("R", "rglru_fwd"), ("W", "wkv6_fwd")):
            assert launched[name] == 40 * cfg.layer_pattern.count(kind) * cfg.num_units, \
                launched


class TestEncoderDecoderOnCard:
    @pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-90b"])
    def test_decode_equals_forward(self, arch):
        """Reduced whisper-tiny (2 C layers, 2 encoder layers over 64 frames)
        and llama-3.2-vision-90b (GC, 16 image tokens), float32, TF32 off:
        decoded token by token (the cross-attention through the forward
        kernel at one query token) against ``forward``, within 2e-4 of the
        logits' scale; the loss's gradients reach the encoder."""
        from repro_torch import kernels
        from repro_torch.configs import get_config
        from repro_torch.launch.steps import init_params, loss_and_grads
        from repro_torch.models import encdec as ED
        from repro_torch.models import transformer as T
        from repro_torch.traces.generate import tf32

        cfg = get_config(arch).reduced(num_layers=2)
        params = init_params(cfg, seed=0, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(0)
        tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=g, device="cuda")
        enc_in = torch.randn(2, cfg.encoder_seq or cfg.num_image_tokens, cfg.d_model,
                             generator=g, device="cuda")
        audio = cfg.arch_type == "audio"
        decoder = params["decoder"] if audio else params
        with tf32(False):
            with torch.no_grad():
                enc = ED.encode(cfg, params["encoder"], enc_in) if audio else enc_in
            kernels.reset_launches()
            decoded, _ = T.prefill_via_decode(cfg, decoder, tokens, 24, encoder_out=enc)
            launched = kernels.all_launches()
            with torch.no_grad():
                full = T.forward(cfg, decoder, tokens, encoder_out=enc)
            _, _, grads = loss_and_grads(cfg, params, tokens, tokens, encoder_in=enc_in)
        scale = float(full.abs().max())
        assert float((decoded - full).abs().max()) <= 2e-4 * scale
        assert launched["flash_fwd"] == 24 * cfg.layer_pattern.count("C") * cfg.num_units
        if audio:
            assert float(grads["encoder"]["layers"][0]["attn"]["wq"].abs().max()) > 0


class TestLaunchersOnCard:
    def test_serve_launcher(self):
        """``python -m repro_torch.launch.serve`` on the card (its default
        device): prefill, greedy decode and the summary."""
        from repro_torch.launch import serve

        out = serve.main(["--arch", "recurrentgemma-2b", "--batch", "4", "--prompt-len", "16",
                          "--gen", "8"])
        assert out["generated"] == 8 and out["decode_tok_per_s"] > 0

    def test_quickstart_twin(self):
        """``python -m repro_torch.examples.quickstart`` on the card: the
        prefetching loader stages batches through its own stream."""
        import math

        from repro_torch.examples import quickstart

        out = quickstart.run(steps=3)
        assert out["device"] == "cuda" and all(math.isfinite(x) for x in out["losses"])
        assert [r.name for r in out["trace"]] == ["fc1", "fc2"]


class TestSweepOnCard:
    def test_frontier_grid_on_cuda_equals_the_cpu(self):
        """The sweep backend's two tiers on the card against the same tiers
        on the CPU, column for column (float64; the reductions may add in
        another order: 1e-12 relative)."""
        import numpy as np

        from repro_torch.core import batched_torch as BT
        from repro_torch.core.scenarios import frontier_grid

        grid = frontier_grid()
        cuda = BT.TorchGridEvaluator(grid, device="cuda")
        on_card = cuda.device_columns()
        assert all(v.device.type == "cuda" and v.dtype == torch.float64
                   for v in on_card.values())
        cpu = BT.TorchGridEvaluator(grid, device="cpu").columns()
        for k, v in on_card.items():
            np.testing.assert_allclose(v.cpu().numpy(), cpu[k], rtol=1e-12, atol=1e-15,
                                       err_msg=k)

    def test_service_on_cuda(self):
        """The sweep service on the card (its default device) over HTTP: a
        coalesced group of torch queries, each within 1e-12 of a direct
        sweep on the card and 1e-6 of the NumPy engine; a simulator-only
        grid is refused on torch and served on NumPy."""
        import threading

        from repro_torch.core import agreement as A
        from repro_torch.launch import serve_sweep

        specs = [{"grid": "frontier", "workloads": ["resnet50"], "seed": 7},
                 {"grid": "mixed", "workloads": ["resnet50"], "workers": [8], "seed": 7},
                 {"workloads": ["resnet50"], "workers": [16], "sync_k": ["none", "3"],
                  "het": ["none", "het:1x0.5+3x1.0"], "stragglers": ["none", "lognormal:0.2x16"],
                  "faults": ["none", "fail:0.1x16"], "seed": 7}]
        srv = serve_sweep.make_server(port=0, window_s=0.5)
        assert srv.service.device.type == "cuda"
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            out = [None] * len(specs)
            threads = [threading.Thread(target=lambda i, s: out.__setitem__(
                i, A.http_query(srv.server_address[1], s)), args=(i, s))
                for i, s in enumerate(specs)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for spec, lines in zip(specs, out):
                got = serve_sweep.table_from_wire(lines)
                assert lines[-1]["backend"] == "torch"
                A.assert_tables_agree(got, A.direct_table(spec, "torch", "cuda"),
                                      A.COALESCED_RTOL)
                A.assert_tables_agree(got, A.direct_table(spec, "numpy"), A.BATCHED_RTOL)
            assert A.http_get(srv.server_address[1], "/stats")["kernel_calls"] >= 1
        finally:
            srv.shutdown()
            srv.server_close()
            srv.service.close()


class TestCNNOnCard:
    @staticmethod
    def _errors(net: str, tf32_on: bool) -> tuple[float, str]:
        """The reduced CNN on the card against the CPU
        (``generate.layer_errors``): the same weights, drawn on the CPU from
        one seed, and inputs."""
        from repro_torch.examples.table6_trace import reduced_networks
        from repro_torch.traces.generate import layer_errors

        (build_cpu, batch), (build_card, _) = (reduced_networks(torch.device(d))[net]
                                               for d in ("cpu", "cuda"))
        (cpu_layers, x0), (card_layers, _) = build_cpu(), build_card()
        x = torch.randn((batch,) + tuple(x0.shape[1:]), generator=torch.Generator().manual_seed(1))
        return layer_errors(cpu_layers, card_layers, x.contiguous(memory_format=torch.channels_last),
                            tf32_on=tf32_on)

    @pytest.mark.parametrize("net", ["alexnet", pytest.param("resnet50", id="resnet")])
    def test_layers_on_the_card_equal_the_cpu(self, net):
        """Every layer's forward and the gradient of its sum in the
        parameters and the input, in float32 with TF32 off (the trace
        generator's setting), within ``F32_LIMIT`` of each tensor's scale
        (cuDNN and the CPU sum in different orders)."""
        from repro_torch.traces.generate import F32_LIMIT

        worst, where = self._errors(net, tf32_on=False)
        assert worst <= F32_LIMIT, f"{net} {where}: {worst:.3e}"

    @pytest.mark.parametrize("net", ["alexnet", pytest.param("resnet50", id="resnet")])
    def test_tf32_fails_the_limit(self, net):
        """The control: the same layers in TF32 read beyond ``F32_LIMIT``,
        so the test above would catch a layer that ran in TF32."""
        from repro_torch.traces.generate import F32_LIMIT

        worst, where = self._errors(net, tf32_on=True)
        assert worst > F32_LIMIT, f"{net} {where}: {worst:.3e}"

    def test_generated_trace_on_the_card(self):
        from repro_torch.models import cnn
        from repro_torch.traces.generate import generate_trace

        layers, x0 = cnn.resnet_timed_layers(0, input_hw=64, depth_per_stage=(1, 1, 1, 1),
                                             width=8, device="cuda")
        x = x0.expand(4, -1, -1, -1).contiguous(memory_format=torch.channels_last)
        flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        trace = generate_trace(layers, x, "resnet-mini", n_iterations=1, repeats=2)
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags
        recs = trace.mean_iteration()
        assert len(recs) == 7 and all(r.forward_us > 0 for r in recs)
        assert [r.backward_us > 0 for r in recs] == [r.size_bytes > 0 for r in recs]


class TestLossOnCard:
    """The chunked cross-entropy's backward on the tensor cores: bf16 x and
    head split ``dlogits`` into three bf16 terms
    (``repro_torch.models.loss``).  "small": 3 x 256 tokens, d 512, vocab
    16 384 (two chunks of 8192), "tied" the same with the head a transposed
    embedding; "cell": internlm2-20b's 3 x 4096 tokens, d 6144, vocab 92 544
    (chunks of 7712); gemma3-1b's and recurrentgemma-2b's tied heads at
    their published widths, 2 x 4096 tokens."""

    SHAPES = {"small": (3, 256, 512, 16_384), "tied": (3, 256, 512, 16_384),
              "cell": (3, 4096, 6144, 92_544), "gemma3-1b": (2, 4096, 1152, 262_144),
              "recurrentgemma-2b": (2, 4096, 2560, 256_000)}
    TIED = ("tied", "gemma3-1b", "recurrentgemma-2b")
    #: a chunk's products from float64, norm-relative: above the split's
    #: readings and the f32 products', below the split's with the leading
    #: term unblocked wherever the inner dimension is 4096 or more (PERF.md)
    LIMIT = 4e-6
    #: the whole backward's bf16 gradients from the f32 path's,
    #: norm-relative: above the split's readings, below one bf16 term's
    WHOLE_LIMIT = 2 ** -11

    @staticmethod
    def _inputs(B, S, D, V, tied=False):
        g = torch.Generator(device="cuda").manual_seed(3)
        x = torch.randn(B, S, D, generator=g, device="cuda").bfloat16()
        head = (torch.randn(V, D, generator=g, device="cuda") / D ** 0.5).bfloat16().T \
            if tied else (torch.randn(D, V, generator=g, device="cuda") / D ** 0.5).bfloat16()
        labels = torch.randint(0, V, (B, S), generator=g, device="cuda")
        return x, head, labels

    @staticmethod
    def _rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    @pytest.mark.parametrize("shape", list(SHAPES))
    def test_split_products_keep_the_f32_precision(self, shape, monkeypatch):
        """One chunk's dx and dhead through the split, and through the f32
        products, lie within ``LIMIT`` of float64.  Two controls show the
        check tells a lower precision apart: one bf16 term of dlogits reads
        at least 10x the limit away, and the split with its leading term
        summed whole, where the inner dimension is 4096 or more, beyond it
        (the tensor cores' accumulator truncates)."""
        from repro_torch.models import loss as L
        from repro_torch.traces.generate import tf32

        B, S, D, V = self.SHAPES[shape]
        x, head, labels = self._inputs(B, S, D, V, tied=shape in self.TIED)
        N, c = B * S, V // L._num_chunks(V, L.DEFAULT_CHUNK)
        x2, hc = x.reshape(N, D), head[:, c:2 * c]
        p = torch.softmax((x2 @ head).float(), dim=-1)[:, c:2 * c]
        loc = labels.reshape(N) - c
        onehot = (torch.arange(c, device="cuda") == loc[:, None]) & \
            ((loc >= 0) & (loc < c))[:, None]
        dlogits = (p - onehot.float()) / N
        del p
        want = (dlogits.double() @ hc.double().T, x2.double().T @ dlogits.double())

        def split():
            dx = torch.zeros(N, D, device="cuda")
            return dx, L.split_products(dlogits, x2, hc, dx)

        got = split()
        with tf32(False):
            f32 = (dlogits @ hc.float().T, x2.float().T @ dlogits)
        one = dlogits.bfloat16()
        ctl = (torch.mm(one, hc.T, out_dtype=torch.float32),
               torch.mm(x2.T, one, out_dtype=torch.float32))
        monkeypatch.setattr(L, "ACC_BLOCK", 1 << 30)
        whole = split()
        rel = self._rel
        for i, (what, inner) in enumerate((("dx", c), ("dhead", N))):
            assert rel(got[i], want[i]) <= self.LIMIT, (what, rel(got[i], want[i]))
            assert rel(f32[i], want[i]) <= self.LIMIT, (what, rel(f32[i], want[i]))
            assert rel(ctl[i], want[i]) >= 10 * self.LIMIT, (what, rel(ctl[i], want[i]))
            if inner >= 4096:
                assert rel(whole[i], want[i]) > self.LIMIT, (what, rel(whole[i], want[i]))

    def test_backward_counts_its_split_chunks(self, monkeypatch):
        """The whole backward at internlm2-20b's cell shape:
        ``loss.split_chunks`` adds one a chunk and call, the gradients
        repeat bit for bit, and they lie within ``WHOLE_LIMIT`` of the f32
        path's, where one bf16 term of dlogits reads beyond it."""
        from repro_torch import tracing
        from repro_torch.models import loss as L
        from repro_torch.traces.generate import tf32

        x, head, labels = self._inputs(*self.SHAPES["cell"])

        def grads():
            xs, hs = x.clone().requires_grad_(), head.clone().requires_grad_()
            return torch.autograd.grad(L.chunked_cross_entropy(xs, hs, labels), (xs, hs))

        assert L.takes_split(x, head)
        with tracing.record("cuda") as rec:
            got = [grads() for _ in range(3)]
        chunks = L._num_chunks(head.shape[1], L.DEFAULT_CHUNK)
        assert rec.summary()["counters"]["loss.split_chunks"] == chunks * 3
        assert all(torch.equal(a, b) for g in got[1:] for a, b in zip(g, got[0]))
        with monkeypatch.context() as m, tf32(False):
            m.setattr(L, "takes_split", lambda x, head: False)
            want = grads()
        with monkeypatch.context() as m:
            m.setattr(L, "split3", lambda t: (t.bfloat16(), *2 * [torch.zeros_like(
                t, dtype=torch.bfloat16)]))
            one_term = grads()
        for a, ctl, b in zip(got[0], one_term, want):
            assert self._rel(a, b) <= self.WHOLE_LIMIT < self._rel(ctl, b), \
                (self._rel(a, b), self._rel(ctl, b))
