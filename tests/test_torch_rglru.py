"""The port's RG-LRU scan against the reference's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both sides.
Forward: ``repro_torch.kernels.ops.rglru`` (``impl="ref"`` and
``impl="kernel"``, which on CPU tensors runs the kernels' plain versions)
against the Pallas kernel in interpret mode and ``repro.kernels.ref.rglru``,
with the tolerances of ``tests/test_kernels.py`` (2e-4 f32, 3e-2 bf16).
Backward: dx, dr, di, dlam and dh0 from the kernels' decomposition
(``RGLRU`` running :func:`repro_torch.kernels.rglru.plain_bwd`, the
reverse-time scan the CUDA kernel computes) and from autograd through the
port's ref, against ``jax.grad`` of the reference's ref: f32 to 1e-5 of the
gradient's scale (both sides sum the same f32 terms over at most 128 steps
in different orders; readings ~2e-7), bf16 to 3e-2.  The CUDA kernels'
three phases, emulated in torch (``rg.chunked_fwd`` / ``rg.chunked_bwd``),
are held to the same references with the same tolerances
(``TestChunkAlgebra``).  The kernels themselves run only on the card
(``tests/test_torch_on_card.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rglru import rglru as pallas_rglru
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru as rg

GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _tol(dtype):
    return 3e-2 if dtype == "bfloat16" else 2e-4


def _inputs(B, S, W, seed=0, r_shift=0.0):
    """x, r, i (B, S, W) and lam (W,) = linspace(0.1, 2, W), as the
    reference's tests and init; ``r_shift`` moves the r gate (very negative:
    sigmoid(r) ~ 0, a ~ 1, the 1e-12 floor under mult is taken)."""
    rng = np.random.default_rng(seed)
    x, r, i = (rng.standard_normal((B, S, W), np.float32) for _ in range(3))
    return x, (r + r_shift).astype(np.float32), i, np.linspace(0.1, 2.0, W, dtype=np.float32)


def _jax(arrs, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


class TestForward:
    @pytest.mark.parametrize("B,S,W,bt,bw", [(2, 128, 128, 128, 128), (2, 64, 128, 32, 64)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_sweep_vs_pallas_and_ref(self, B, S, W, bt, bw, dtype):
        x, r, i, lam = _inputs(B, S, W)
        jx, jr, ji = _jax((x, r, i), dtype)
        want_pallas, wh_pallas = pallas_rglru(jx, jr, ji, jnp.asarray(lam), block_t=bt,
                                              block_w=bw, interpret=True)
        want_ref, wh_ref = jref.rglru(jx, jr, ji, jnp.asarray(lam))
        for impl in ("ref", "kernel"):
            out, h = ops.rglru(*_torch((x, r, i), dtype), torch.from_numpy(lam), impl=impl)
            assert out.dtype == getattr(torch, dtype) and h.dtype == torch.float32
            assert tuple(out.shape) == want_ref.shape and tuple(h.shape) == wh_ref.shape
            for want, wh in ((want_pallas, wh_pallas), (want_ref, wh_ref)):
                assert _err(_np(out), want.astype(jnp.float32)) < _tol(dtype)
                assert _err(_np(h), wh) < _tol(dtype)

    @pytest.mark.parametrize("S,W", [(100, 200), (37, 136)])
    def test_ragged_shape_vs_ref(self, S, W):
        """S and W no multiple of 128: the Pallas kernel rejects them, the
        port masks the ragged edge."""
        x, r, i, lam = _inputs(2, S, W, seed=1)
        h0 = np.random.default_rng(2).standard_normal((2, W), np.float32)
        with pytest.raises(ValueError, match="multiples"):
            pallas_rglru(*_jax((x, r, i), "float32"), jnp.asarray(lam), block_t=64,
                         interpret=True)
        want, wh = jref.rglru(*_jax((x, r, i, lam), "float32"), h0=jnp.asarray(h0))
        for impl in ("ref", "kernel"):
            out, h = ops.rglru(*_torch((x, r, i, lam), "float32"), torch.from_numpy(h0),
                               impl=impl)
            assert _err(_np(out), want) < 2e-4 and _err(_np(h), wh) < 2e-4

    @pytest.mark.parametrize("split", [64, 37])
    def test_carried_state(self, split):
        """Two halves, the second from the first's final state, equal the
        whole sequence (``tests/test_kernels.py::TestRGLRU::test_carried_state``)."""
        x, r, i, lam = _torch(_inputs(1, 128, 128, seed=3), "float32")
        for impl in ("ref", "kernel"):
            full, h_full = ops.rglru(x, r, i, lam, impl=impl)
            o1, h1 = ops.rglru(x[:, :split].contiguous(), r[:, :split].contiguous(),
                               i[:, :split].contiguous(), lam, impl=impl)
            o2, h2 = ops.rglru(x[:, split:].contiguous(), r[:, split:].contiguous(),
                               i[:, split:].contiguous(), lam, h0=h1, impl=impl)
            assert float((torch.cat([o1, o2], 1) - full).abs().max()) < 1e-5
            assert float((h2 - h_full).abs().max()) < 1e-5


class TestBackward:
    @pytest.mark.parametrize("B,S,W,r_shift,with_h0", [
        (2, 64, 128, 0.0, False),
        (2, 100, 40, 0.0, True),
        (1, 128, 64, -40.0, True),     # sigmoid(r) ~ 4e-18: a ~ 1, mult floored
        (2, 48, 32, -8.0, False),      # a near 1, the floor not taken
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_grads_vs_jax_grad_of_ref(self, B, S, W, r_shift, with_h0, dtype):
        x, r, i, lam = _inputs(B, S, W, seed=4, r_shift=r_shift)
        rng = np.random.default_rng(5)
        h0 = rng.standard_normal((B, W), np.float32) if with_h0 else None
        dout = rng.standard_normal((B, S, W), np.float32)
        dh_last = rng.standard_normal((B, W), np.float32)

        def f(x, r, i, lam, h0):
            out, h = jref.rglru(x, r, i, lam, h0=h0)
            return jnp.sum(out.astype(jnp.float32) * dout) + jnp.sum(h * dh_last)

        args = [*_jax((x, r, i), dtype), jnp.asarray(lam),
                None if h0 is None else jnp.asarray(h0)]
        argnums = (0, 1, 2, 3, 4) if with_h0 else (0, 1, 2, 3)
        want = jax.grad(f, argnums=argnums)(*args)
        for impl in ("ref", "kernel"):
            ts = [*_torch((x, r, i), dtype), torch.from_numpy(lam)]
            if with_h0:
                ts.append(torch.from_numpy(h0))
            for t in ts:
                t.requires_grad_()
            out, h = ops.rglru(*ts[:4], h0=ts[4] if with_h0 else None, impl=impl)
            got = torch.autograd.grad(
                (out, h), ts, (torch.from_numpy(dout).to(out.dtype), torch.from_numpy(dh_last)))
            for name, g, w, t in zip(("dx", "dr", "di", "dlam", "dh0"), got, want, ts):
                w = np.asarray(w, np.float32)
                assert g.dtype == t.dtype, (impl, name)
                assert _err(_np(g), w) <= GRAD_TOL[dtype] * max(1.0, float(np.abs(w).max())), \
                    (impl, name)

    def test_floor_zeroes_the_mult_term_of_dr(self):
        """Where 1 - exp(2 log a) is under the 1e-12 floor, dlog_a is only
        dh * h_{t-1} * a, as jax.grad of ``jnp.maximum`` gives."""
        x, r, i, lam = _torch(_inputs(1, 16, 8, seed=6, r_shift=-60.0), "float32")
        out, h, states = rg.plain_fwd(x, r, i, lam, save_states=True)
        dout = torch.ones_like(x)
        dx, dr, di, dlam, dh0 = rg.plain_bwd(x, r, i, lam, None, states, dout)
        assert torch.isfinite(torch.stack([dx, dr, di])).all()
        assert float(dr.abs().max()) < 1e-20 and torch.isfinite(dlam).all()

    def test_plain_bwd_is_autograd_of_plain_fwd(self):
        """The reverse-time scan the kernel computes equals autograd through
        the reference's forward scan (the definition it is held to on the
        card)."""
        x, r, i, lam = [t.requires_grad_() for t in _torch(_inputs(2, 40, 24, seed=7),
                                                           "float32")]
        h0 = torch.randn(2, 24, generator=torch.Generator().manual_seed(0), requires_grad=True)
        dout = torch.randn(2, 40, 24, generator=torch.Generator().manual_seed(1))
        dh_last = torch.randn(2, 24, generator=torch.Generator().manual_seed(2))
        out, h = tref.rglru(x, r, i, lam, h0)
        want = torch.autograd.grad((out, h), (x, r, i, lam, h0), (dout, dh_last))
        _, _, states = rg.plain_fwd(x.detach(), r.detach(), i.detach(), lam.detach(),
                                    h0.detach(), save_states=True)
        got = rg.plain_bwd(x.detach(), r.detach(), i.detach(), lam.detach(), h0.detach(),
                           states, dout, dh_last)
        for g, w in zip(got, want):
            assert torch.allclose(g, w, atol=1e-5)


# (B, S, W, r_shift, lam, with_h0, with_dh_last): S below one chunk, one
# whole chunk, one step past it, ragged at 100 and at 1000, sigmoid(r) ~ 0
# (a ~ 1, the floor under mult taken), and lam = 20 (a ~ e^-160 sigmoid(r):
# every chunk's decay product underflows to exactly 0)
CHUNK_SHAPES = [
    (2, rg.CHUNK - 5, 24, 0.0, None, True, True),
    (2, rg.CHUNK, 16, 0.0, None, False, False),
    (1, rg.CHUNK + 1, 16, 0.0, None, True, False),
    (2, 100, 40, 0.0, None, False, True),
    (1, 1000, 8, 0.0, None, True, True),
    (1, 130, 16, -40.0, None, True, True),
    (2, 200, 8, 0.0, 20.0, True, True),
]
CHUNK_CASES = [(*shape, dtype) for shape in CHUNK_SHAPES for dtype in ("float32", "bfloat16")]


def _chunk_case(B, S, W, r_shift, lam, with_h0, with_dh_last):
    """(x, r, i, lam), h0 or None, dout, dh_last or None as numpy."""
    x, r, i, lam_ = _inputs(B, S, W, seed=8, r_shift=r_shift)
    if lam is not None:
        lam_ = np.full(W, lam, np.float32)
    rng = np.random.default_rng(9)
    h0 = rng.standard_normal((B, W), np.float32) if with_h0 else None
    dout = rng.standard_normal((B, S, W), np.float32)
    dh_last = rng.standard_normal((B, W), np.float32) if with_dh_last else None
    return (x, r, i, lam_), h0, dout, dh_last


def _opt(a):
    return None if a is None else torch.from_numpy(a)


class TestChunkAlgebra:
    """The kernels' three forward and three backward phases, emulated in
    torch, against the JAX reference: exact however strong or weak the
    decay, since the chunk algebra takes only products of a."""

    @pytest.mark.parametrize("B,S,W,r_shift,lam,with_h0,with_dh_last,dtype", CHUNK_CASES)
    def test_forward_vs_jax_ref(self, B, S, W, r_shift, lam, with_h0, with_dh_last, dtype):
        arrs, h0, _, _ = _chunk_case(B, S, W, r_shift, lam, with_h0, with_dh_last)
        want, wh = jref.rglru(*_jax(arrs[:3], dtype), jnp.asarray(arrs[3]),
                              h0=None if h0 is None else jnp.asarray(h0))
        ts = [*_torch(arrs[:3], dtype), torch.from_numpy(arrs[3])]
        if lam is not None:  # the case does what it says: Π a over a chunk is 0.0
            a = torch.exp(-8.0 * tref.softplus(ts[3]) * torch.sigmoid(ts[1].float()))
            assert bool((a[:, :rg.CHUNK].prod(1) == 0.0).all())
        out, h_last, states, starts = rg.chunked_fwd(*ts, _opt(h0))
        assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == want.shape
        assert states.dtype == torch.float32 and states.shape == out.shape
        assert starts.shape == (B, rg.num_chunks(S), W)
        for t in (out, h_last, states, starts):
            assert torch.isfinite(t).all()
        assert _err(_np(out), want.astype(jnp.float32)) < _tol(dtype)
        assert _err(_np(h_last), wh) < _tol(dtype)

    @pytest.mark.parametrize("B,S,W,r_shift,lam,with_h0,with_dh_last,dtype", CHUNK_CASES)
    def test_backward_vs_jax_grad(self, B, S, W, r_shift, lam, with_h0, with_dh_last, dtype):
        """dx, dr, di, dlam and the carried state's gradient, with and
        without a final-state cotangent, from the states the forward phases
        give."""
        arrs, h0, dout, dh_last = _chunk_case(B, S, W, r_shift, lam, with_h0, with_dh_last)

        def f(x, r, i, lam, h0):
            out, h = jref.rglru(x, r, i, lam, h0=h0)
            loss = jnp.sum(out.astype(jnp.float32) * dout)
            return loss if dh_last is None else loss + jnp.sum(h * dh_last)

        args = [*_jax(arrs[:3], dtype), jnp.asarray(arrs[3]),
                None if h0 is None else jnp.asarray(h0)]
        want = jax.grad(f, argnums=(0, 1, 2, 3, 4) if with_h0 else (0, 1, 2, 3))(*args)
        ts = [*_torch(arrs[:3], dtype), torch.from_numpy(arrs[3])]
        states = rg.chunked_fwd(*ts, _opt(h0))[2]
        got = rg.chunked_bwd(*ts, _opt(h0), states, torch.from_numpy(dout).to(ts[0].dtype),
                             _opt(dh_last))
        for name, g, w in zip(("dx", "dr", "di", "dlam", "dh0"), got, want):
            w = np.asarray(w, np.float32)
            assert g.dtype == (ts[0].dtype if name in ("dx", "dr", "di") else torch.float32)
            assert torch.isfinite(g).all(), name
            assert _err(_np(g), w) <= GRAD_TOL[dtype] * max(1.0, float(np.abs(w).max())), name

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_forward_vs_pallas_interpret(self, dtype):
        """At a shape the Pallas kernel takes (S, W multiples of its blocks):
        the chunks against its 64-step time blocks."""
        x, r, i, lam = _inputs(2, 128, 128, seed=10)
        h0 = np.random.default_rng(11).standard_normal((2, 128), np.float32)
        want, wh = pallas_rglru(*_jax((x, r, i), dtype), jnp.asarray(lam), jnp.asarray(h0),
                                block_t=64, block_w=128, interpret=True)
        out, h_last, _, _ = rg.chunked_fwd(*_torch((x, r, i), dtype), torch.from_numpy(lam),
                                           torch.from_numpy(h0))
        assert _err(_np(out), want.astype(jnp.float32)) < _tol(dtype)
        assert _err(_np(h_last), wh) < _tol(dtype)

    @pytest.mark.parametrize("S,r_shift,lam,with_h0", [(1000, 0.0, None, True),
                                                       (130, -40.0, None, False),
                                                       (200, 0.0, 20.0, True)])
    def test_chunk_starts_are_the_reference_states(self, S, r_shift, lam, with_h0):
        """Phase 2's chunk-start states equal the port's step scan
        (``ref.rglru_states``) at the chunk boundaries: h0 (or 0) before the
        first chunk, h_{c CHUNK - 1} before chunk c."""
        arrs, h0, _, _ = _chunk_case(2, S, 24, r_shift, lam, with_h0, False)
        ts = _torch(arrs, "float32")
        _, h_last, _, starts = rg.chunked_fwd(*ts, _opt(h0))
        want, want_last = tref.rglru_states(*ts, _opt(h0))
        first = torch.zeros(2, 24) if h0 is None else torch.from_numpy(h0)
        want_starts = torch.cat([first[:, None], want[:, rg.CHUNK - 1:-1:rg.CHUNK]], 1)
        assert starts.shape == want_starts.shape
        scale = max(1.0, float(want.abs().max()))
        assert float((starts - want_starts).abs().max()) <= 1e-5 * scale
        assert float((h_last - want_last).abs().max()) <= 1e-5 * scale

    @pytest.mark.parametrize("S", [rg.CHUNK - 5, 150])
    def test_phases_match_the_plain_versions(self, S):
        """The emulation and the plain versions (the reference scans the CPU
        wrappers run) agree: two computations of one function."""
        arrs, h0, dout, dh_last = _chunk_case(2, S, 24, 0.0, None, True, True)
        ts = _torch(arrs, "float32")
        h0, dout, dh_last = (torch.from_numpy(a) for a in (h0, dout, dh_last))
        want_fwd = rg.plain_fwd(*ts, h0, save_states=True)
        for got, want in zip(rg.chunked_fwd(*ts, h0)[:3], want_fwd):
            assert float((got - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))
        states = want_fwd[2]
        for got, want in zip(rg.chunked_bwd(*ts, h0, states, dout, dh_last),
                             rg.plain_bwd(*ts, h0, states, dout, dh_last)):
            assert float((got - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))


class TestDispatchAndChecks:
    def _args(self, dtype=torch.float32, B=1, S=8, W=16):
        return _torch(_inputs(B, S, W), "float32")[:3], torch.linspace(0.1, 2.0, W)

    def test_auto_is_ref_on_cpu(self):
        (x, r, i), lam = self._args()
        rg.reset_launches()
        out, h = ops.rglru(x, r, i, lam)
        want, wh = tref.rglru(x, r, i, lam)
        assert torch.equal(out, want) and torch.equal(h, wh)
        assert all(n == 0 for n in rg.LAUNCHES.values())

    def test_cpu_wrappers_count_no_launches(self):
        (x, r, i), lam = self._args()
        rg.reset_launches()
        x.requires_grad_()
        out, _ = ops.rglru(x, r, i, lam, impl="kernel")
        out.sum().backward()
        assert x.grad is not None
        assert all(n == 0 for n in rg.LAUNCHES.values())

    def test_states_saved_only_for_a_gradient(self):
        (x, r, i), lam = self._args()
        assert rg.fwd(x, r, i, lam)[2] is None
        _, _, states = rg.fwd(x, r, i, lam, save_states=True)
        assert states.dtype == torch.float32 and states.shape == x.shape

    def test_cases_the_kernel_does_not_take_raise(self):
        (x, r, i), lam = self._args()
        bad = [
            ((x.half(), r.half(), i.half(), lam), "dtype"),
            ((x, r.to(torch.bfloat16), i, lam), "one dtype"),
            ((x, r, i, lam.to(torch.bfloat16)), "lam"),
            ((x, r, i, lam[:-1]), "lam"),
            ((x.transpose(0, 1).contiguous().transpose(0, 1)[:, ::2], r[:, ::2],
              i[:, ::2], lam), "contiguous"),
            ((x[0], r[0], i[0], lam), "B, S, W"),
            ((x[:, :0], r[:, :0], i[:, :0], lam), ">= 1"),
        ]
        for args, match in bad:
            with pytest.raises(ValueError, match=match):
                rg.fwd(*args)
        with pytest.raises(ValueError, match="h0"):
            rg.fwd(x, r, i, lam, torch.zeros(2, 16))
        with pytest.raises(ValueError, match="states"):
            rg.bwd(x, r, i, lam, None, None, x)

    def test_unknown_impl_raises(self):
        (x, r, i), lam = self._args()
        with pytest.raises(ValueError, match="impl"):
            ops.rglru(x, r, i, lam, impl="pallas")

    def test_importing_builds_nothing(self):
        assert rg._lib is None

    def test_chunk_is_the_source_chunk(self):
        """``CHUNK`` (the emulation's, and the scratch buffers' sizes) is the
        kernels' ``CK``."""
        import re

        src = rg.SOURCE.read_text()
        assert int(re.search(r"constexpr int CK = (\d+);", src).group(1)) == rg.CHUNK
        C = rg.CHUNK
        assert [rg.num_chunks(S) for S in (1, C, C + 1, 16 * C)] == [1, 1, 2, 16]

    def test_occupancy_rejects_an_unknown_kernel_before_building(self):
        with pytest.raises(ValueError, match="one of"):
            rg.occupancy("rglru_fwd")
        assert rg._lib is None
