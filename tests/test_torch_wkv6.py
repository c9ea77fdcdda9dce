"""The port's RWKV6 wkv scan against the reference's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both sides: r, k
0.5 N(0, 1), v N(0, 1), u 0.3 N(0, 1), and the decay w "mild" (exp(-exp(N(0,
1) - 3)), the repository's kernel tests), "strong" (uniform in [1e-3, 0.2]),
"one" (exp(-exp(N(0, 1) - 12)), which bfloat16 rounds to exactly 1.0) or
"zero" (strong, with a quarter of the entries exactly 0).

Forward: ``repro_torch.kernels.ops.wkv6`` (``impl="ref"`` and
``impl="kernel"``, which on CPU tensors runs the kernels' plain versions)
against ``repro.kernels.ref.wkv6``, f32 to 1e-5 and bf16 to 3e-2 of the
output's scale (max(1, max |want|): both sides sum the same f32 terms in
different orders, and in bf16 both round once), and against the Pallas
kernel in interpret mode at the mild decays and shapes of
``tests/test_kernels.py``, to that file's bounds (1e-3 f32, 6e-2 bf16;
state 1e-3); in bf16 an entry may also differ by one rounding step of its
value (2^-7 |want|): the port's f32 sums run in another order than XLA's,
and an output above 8 that lands on the other side of a rounding boundary
differs by 0.0625.  The Pallas kernel is held only at mild decays: its
chunked log-decay form overflows float32 at strong ones, where the port
follows ``ref.wkv6``.
Backward: dr, dk, dv, dw, du and the state's gradient from the kernels'
decomposition (``WKV6`` running :func:`repro_torch.kernels.wkv6.plain_bwd`,
the chunked reverse-time scan the CUDA kernel computes) and from autograd
through the port's ref, against ``jax.grad`` of the reference's ref, with a
final-state cotangent: f32 to 1e-5 of the gradient's scale, bf16 to 3e-2.
Chunk algebra: :func:`repro_torch.kernels.wkv6.chunked_fwd` and
``chunked_bwd`` compute, phase by phase and in torch, what the CUDA kernels
compute (per-chunk local states and decay products, the combine over
chunks, the per-chunk step scans); they are held against ``ref.wkv6`` and
``jax.grad`` of it to ``TOL`` at every decay above, at S = 1000, 63 and 1
and with a carried state, and their chunk-start states against
``ref.wkv6_checkpointed``'s checkpoints.
The kernels themselves run only on the card (``tests/test_torch_on_card.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.wkv6 import wkv6 as pallas_wkv6
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wkv6 as wk

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
#: tests/test_kernels.py::TestWKV6 bounds for the Pallas kernel
PALLAS_TOL = {"float32": 1e-3, "bfloat16": 6e-2}


def _inputs(B, S, H, hd, seed=0, decay="mild"):
    """r, k, v, w (B, S, H, hd) and u (H, hd), float32 numpy."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    r, k, v = 0.5 * n(B, S, H, hd), 0.5 * n(B, S, H, hd), n(B, S, H, hd)
    if decay in ("strong", "zero"):
        w = rng.uniform(1e-3, 0.2, (B, S, H, hd)).astype(np.float32)
        if decay == "zero":
            w[rng.uniform(size=w.shape) < 0.25] = 0.0
    else:
        w = np.exp(-np.exp(n(B, S, H, hd) - (12.0 if decay == "one" else 3.0)))
    return r, k, v, w.astype(np.float32), 0.3 * n(H, hd)


def _jax(arrs, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _close(got, want, tol) -> bool:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) <= tol * max(1.0, float(np.abs(want).max()))


class TestForward:
    @pytest.mark.parametrize("B,S,H,hd", [(2, 128, 2, 64), (1, 256, 4, 64), (1, 64, 1, 32),
                                          (2, 100, 2, 64)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_vs_ref(self, B, S, H, hd, dtype):
        r, k, v, w, u = _inputs(B, S, H, hd)
        want, ws = jref.wkv6(*_jax((r, k, v, w), dtype), jnp.asarray(u))
        for impl in ("ref", "kernel"):
            out, st = ops.wkv6(*_torch((r, k, v, w), dtype), torch.from_numpy(u), impl=impl)
            assert out.dtype == getattr(torch, dtype) and st.dtype == torch.float32
            assert tuple(out.shape) == want.shape and tuple(st.shape) == ws.shape
            assert _close(_np(out), want.astype(jnp.float32), TOL[dtype]), impl
            assert _close(_np(st), ws, TOL[dtype]), impl

    @pytest.mark.parametrize("B,S,H,hd,bt", [(2, 128, 2, 64, 64), (1, 256, 4, 64, 64),
                                             (1, 64, 1, 32, 32)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_vs_pallas_at_mild_decays(self, B, S, H, hd, bt, dtype):
        r, k, v, w, u = _inputs(B, S, H, hd, seed=1)
        want, ws = pallas_wkv6(*_jax((r, k, v, w), dtype), jnp.asarray(u), block_t=bt,
                               interpret=True)
        for impl in ("ref", "kernel"):
            out, st = ops.wkv6(*_torch((r, k, v, w), dtype), torch.from_numpy(u), impl=impl)
            want32 = np.asarray(want, np.float32)
            step = 2.0 ** -7 * np.abs(want32) if dtype == "bfloat16" else 0.0
            assert (np.abs(_np(out) - want32) <= np.maximum(PALLAS_TOL[dtype], step)).all()
            assert float(np.abs(_np(st) - np.asarray(ws)).max()) < 1e-3

    @pytest.mark.parametrize("decay,dtype", [("strong", "float32"), ("strong", "bfloat16"),
                                             ("one", "bfloat16")])
    def test_strong_decay_and_unit_decay_vs_ref(self, decay, dtype):
        """w down to 1e-3, where the Pallas kernel's exp(-cumsum(log w))
        overflows; and w that bfloat16 rounds to exactly 1.0 (log w = 0),
        as the model's cast does to decays near 1."""
        r, k, v, w, u = _inputs(2, 130, 2, 64, seed=2, decay=decay)
        args = _torch((r, k, v, w), dtype)
        if decay == "one":
            assert bool((args[3] == 1.0).all())
        want, ws = jref.wkv6(*_jax((r, k, v, w), dtype), jnp.asarray(u))
        for impl in ("ref", "kernel"):
            out, st = ops.wkv6(*args, torch.from_numpy(u), impl=impl)
            assert torch.isfinite(out).all() and torch.isfinite(st).all()
            assert _close(_np(out), want.astype(jnp.float32), TOL[dtype]), impl
            assert _close(_np(st), ws, TOL[dtype]), impl

    @pytest.mark.parametrize("split", [64, 37])
    def test_carried_state(self, split):
        """Two halves, the second from the first's final state, equal the
        whole sequence (``tests/test_kernels.py::TestWKV6::
        test_carried_state_equals_one_shot``)."""
        r, k, v, w, u = _torch(_inputs(1, 128, 2, 64, seed=3), "float32")
        for impl in ("ref", "kernel"):
            full, s_full = ops.wkv6(r, k, v, w, u, impl=impl)
            halves = [t[:, :split].contiguous() for t in (r, k, v, w)]
            o1, s1 = ops.wkv6(*halves, u, impl=impl)
            o2, s2 = ops.wkv6(*(t[:, split:].contiguous() for t in (r, k, v, w)), u,
                              state=s1, impl=impl)
            assert float((torch.cat([o1, o2], 1) - full).abs().max()) < 1e-4
            assert float((s2 - s_full).abs().max()) < 1e-4

    def test_checkpoints_are_the_states_before_each_chunk(self):
        r, k, v, w, u = _torch(_inputs(2, 150, 2, 32, seed=4), "float32")
        s0 = torch.randn(2, 2, 32, 32, generator=torch.Generator().manual_seed(0))
        _, s_last, ckpt = wk.plain_fwd(r, k, v, w, u, s0, save_ckpt=True)
        assert ckpt.shape == (2, 2, 3, 32, 32) and wk.num_checkpoints(150) == 3
        assert torch.equal(ckpt[:, :, 0], s0)
        for c in (1, 2):
            n = c * wk.CHECKPOINT
            _, want = tref.wkv6(r[:, :n], k[:, :n], v[:, :n], w[:, :n], u, s0)
            assert float((ckpt[:, :, c] - want).abs().max()) < 1e-5
        assert float((s_last - tref.wkv6(r, k, v, w, u, s0)[1]).abs().max()) < 1e-5


class TestBackward:
    @pytest.mark.parametrize("B,S,H,hd,decay,with_state", [
        (2, 64, 2, 64, "mild", False),
        (2, 100, 2, 32, "mild", True),     # ragged: a full and a partial chunk
        (1, 130, 1, 64, "strong", True),   # w down to 1e-3, three chunks
        (2, 48, 2, 64, "one", False),      # bf16 rounds w to 1.0
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_grads_vs_jax_grad_of_ref(self, B, S, H, hd, decay, with_state, dtype):
        r, k, v, w, u = _inputs(B, S, H, hd, seed=5, decay=decay)
        rng = np.random.default_rng(6)
        s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32) if with_state else None
        dout = rng.standard_normal((B, S, H, hd)).astype(np.float32)
        ds_last = rng.standard_normal((B, H, hd, hd)).astype(np.float32)

        def f(r, k, v, w, u, s0):
            out, st = jref.wkv6(r, k, v, w, u, state=s0)
            return jnp.sum(out.astype(jnp.float32) * dout) + jnp.sum(st * ds_last)

        args = [*_jax((r, k, v, w), dtype), jnp.asarray(u),
                None if s0 is None else jnp.asarray(s0)]
        argnums = (0, 1, 2, 3, 4, 5) if with_state else (0, 1, 2, 3, 4)
        want = jax.grad(f, argnums=argnums)(*args)
        for impl in ("ref", "kernel"):
            ts = [*_torch((r, k, v, w), dtype), torch.from_numpy(u)]
            if with_state:
                ts.append(torch.from_numpy(s0))
            for t in ts:
                t.requires_grad_()
            out, st = ops.wkv6(*ts[:5], state=ts[5] if with_state else None, impl=impl)
            got = torch.autograd.grad(
                (out, st), ts, (torch.from_numpy(dout).to(out.dtype), torch.from_numpy(ds_last)))
            for name, g, wnt, t in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want, ts):
                assert g.dtype == t.dtype, (impl, name)
                assert _close(_np(g), wnt, TOL[dtype]), (impl, name)

    def test_plain_bwd_is_autograd_of_the_reference_scan(self):
        """The chunked reverse-time scan the kernel computes equals autograd
        through the reference's forward scan (the definition it is held to
        on the card), across a ragged last chunk."""
        r, k, v, w, u = [t.requires_grad_() for t in _torch(_inputs(2, 140, 2, 32, seed=7),
                                                            "float32")]
        gen = torch.Generator().manual_seed(1)
        s0 = torch.randn(2, 2, 32, 32, generator=gen, requires_grad=True)
        dout = torch.randn(2, 140, 2, 32, generator=gen)
        ds_last = torch.randn(2, 2, 32, 32, generator=gen)
        out, st = tref.wkv6(r, k, v, w, u, s0)
        want = torch.autograd.grad((out, st), (r, k, v, w, u, s0), (dout, ds_last))
        plain = [t.detach() for t in (r, k, v, w, u)]
        _, _, ckpt = wk.plain_fwd(*plain, s0.detach(), save_ckpt=True)
        got = wk.plain_bwd(*plain, ckpt, dout, ds_last)
        for g, wnt in zip(got, want):
            assert float((g - wnt).abs().max()) <= 1e-5 * max(1.0, float(wnt.abs().max()))

    def test_zero_decay_gives_finite_gradients(self):
        """w = 0 exactly (the state forgets everything each step): no
        division by w, so every gradient is finite and equals autograd's."""
        r, k, v, _, u = _torch(_inputs(1, 70, 1, 32, seed=8), "float32")
        w = torch.zeros_like(r)
        leaves = [t.requires_grad_() for t in (r, k, v, w, u)]
        dout = torch.randn(r.shape, generator=torch.Generator().manual_seed(2))
        for fn in (wk.wkv6, tref.wkv6):
            out, _ = fn(*leaves)
            got = torch.autograd.grad(out, leaves, dout)
            assert all(torch.isfinite(g).all() for g in got)
            if fn is wk.wkv6:
                first = got
        for g, wnt in zip(first, got):
            assert float((g - wnt).abs().max()) <= 1e-5 * max(1.0, float(wnt.abs().max()))


#: (B, S, H, hd, decay, dtype, carried state): S = 1000 (16 chunks, the last
#: ragged), 63 (one partial chunk) and 1, at every decay and both dtypes
CHUNK_CASES = [
    (1, 1000, 2, 32, "mild", "float32", False),
    (1, 1000, 1, 64, "strong", "float32", True),
    (1, 1000, 1, 32, "zero", "bfloat16", True),
    (2, 63, 2, 64, "strong", "bfloat16", False),
    (2, 63, 1, 32, "one", "bfloat16", True),
    (1, 130, 2, 64, "zero", "float32", False),
    (2, 1, 2, 32, "mild", "float32", True),
    (1, 1, 1, 64, "one", "bfloat16", False),
]


def _chunk_case(B, S, H, hd, decay, dtype, with_state, seed=11):
    r, k, v, w, u = _inputs(B, S, H, hd, seed=seed, decay=decay)
    rng = np.random.default_rng(seed + 1)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32) if with_state else None
    dout = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    ds_last = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return (r, k, v, w, u), s0, dout, ds_last


class TestChunkAlgebra:
    """The kernels' three forward and three backward phases, emulated in
    torch (``wk.chunked_fwd`` / ``wk.chunked_bwd``), against the JAX
    reference: exact at any decay, since the phases take only products of
    w (no log, exp or division)."""

    @pytest.mark.parametrize("B,S,H,hd,decay,dtype,with_state", CHUNK_CASES)
    def test_forward_vs_jax_ref(self, B, S, H, hd, decay, dtype, with_state):
        arrs, s0, _, _ = _chunk_case(B, S, H, hd, decay, dtype, with_state)
        want, ws = jref.wkv6(*_jax(arrs[:4], dtype), jnp.asarray(arrs[4]),
                             state=None if s0 is None else jnp.asarray(s0))
        args = _torch(arrs[:4], dtype)
        if decay == "one":
            assert bool((args[3] == 1.0).all())
        out, s_last, ckpt = wk.chunked_fwd(*args, torch.from_numpy(arrs[4]),
                                           None if s0 is None else torch.from_numpy(s0))
        assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == want.shape
        assert ckpt.shape == (B, H, wk.num_checkpoints(S), hd, hd)
        assert torch.isfinite(out).all() and torch.isfinite(s_last).all()
        assert _close(_np(out), want.astype(jnp.float32), TOL[dtype])
        assert _close(_np(s_last), ws, TOL[dtype])

    @pytest.mark.parametrize("B,S,H,hd,decay,dtype,with_state", CHUNK_CASES)
    def test_backward_vs_jax_grad(self, B, S, H, hd, decay, dtype, with_state):
        """dr, dk, dv, dw, du and the carried state's gradient, with a
        final-state cotangent, from the chunk-start states the forward
        phases give."""
        arrs, s0, dout, ds_last = _chunk_case(B, S, H, hd, decay, dtype, with_state)

        def f(r, k, v, w, u, s0):
            out, st = jref.wkv6(r, k, v, w, u, state=s0)
            return jnp.sum(out.astype(jnp.float32) * dout) + jnp.sum(st * ds_last)

        args = [*_jax(arrs[:4], dtype), jnp.asarray(arrs[4]),
                None if s0 is None else jnp.asarray(s0)]
        want = jax.grad(f, argnums=(0, 1, 2, 3, 4, 5) if with_state else (0, 1, 2, 3, 4))(*args)
        ts = [*_torch(arrs[:4], dtype), torch.from_numpy(arrs[4])]
        state = None if s0 is None else torch.from_numpy(s0)
        _, _, ckpt = wk.chunked_fwd(*ts, state)
        got = wk.chunked_bwd(*ts, ckpt, torch.from_numpy(dout).to(ts[0].dtype),
                             torch.from_numpy(ds_last))
        for name, g, wnt in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
            assert g.dtype == (ts[0].dtype if name in ("dr", "dk", "dv", "dw")
                               else torch.float32), name
            assert torch.isfinite(g).all(), name
            assert _close(_np(g), wnt, TOL[dtype]), name

    @pytest.mark.parametrize("S,decay,with_state", [(1000, "strong", True), (150, "zero", False),
                                                    (64, "mild", True)])
    def test_chunk_starts_are_the_reference_checkpoints(self, S, decay, with_state):
        """Phase 2's chunk-start states equal the checkpoints of the port's
        step scan (``ref.wkv6_checkpointed``), which the backward reads."""
        arrs, s0, _, _ = _chunk_case(1, S, 2, 32, decay, "float32", with_state)
        ts = _torch(arrs, "float32")
        state = None if s0 is None else torch.from_numpy(s0)
        _, s_last, ckpt = wk.chunked_fwd(*ts, state)
        _, want_last, want = tref.wkv6_checkpointed(*ts, state, wk.CHECKPOINT)
        assert ckpt.shape == want.shape
        scale = max(1.0, float(want.abs().max()))
        assert float((ckpt - want).abs().max()) <= 1e-5 * scale
        assert float((s_last - want_last).abs().max()) <= 1e-5 * scale

    def test_phases_match_the_plain_versions(self):
        """The emulation and the plain versions (the reference scans the CPU
        wrappers run) agree: two computations of one function."""
        arrs, s0, dout, ds_last = _chunk_case(2, 150, 2, 32, "mild", "float32", True)
        ts = _torch(arrs, "float32")
        state, dout, ds_last = (torch.from_numpy(x) for x in (s0, dout, ds_last))
        for got, want in zip(wk.chunked_fwd(*ts, state),
                             wk.plain_fwd(*ts, state, save_ckpt=True)):
            assert float((got - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))
        _, _, ckpt = wk.plain_fwd(*ts, state, save_ckpt=True)
        for got, want in zip(wk.chunked_bwd(*ts, ckpt, dout, ds_last),
                             wk.plain_bwd(*ts, ckpt, dout, ds_last)):
            assert float((got - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))


class TestDispatchAndChecks:
    def _args(self, B=1, S=8, H=2, hd=32):
        return _torch(_inputs(B, S, H, hd), "float32")

    def test_auto_is_ref_on_cpu(self):
        r, k, v, w, u = self._args()
        wk.reset_launches()
        out, st = ops.wkv6(r, k, v, w, u)
        want, ws = tref.wkv6(r, k, v, w, u)
        assert torch.equal(out, want) and torch.equal(st, ws)
        assert all(n == 0 for n in wk.LAUNCHES.values())

    def test_cpu_wrappers_count_no_launches(self):
        r, k, v, w, u = self._args()
        wk.reset_launches()
        r.requires_grad_()
        out, _ = ops.wkv6(r, k, v, w, u, impl="kernel")
        out.sum().backward()
        assert r.grad is not None
        assert all(n == 0 for n in wk.LAUNCHES.values())

    def test_checkpoints_saved_only_for_a_gradient(self):
        r, k, v, w, u = self._args(S=70)
        assert wk.fwd(r, k, v, w, u)[2] is None
        _, _, ckpt = wk.fwd(r, k, v, w, u, save_ckpt=True)
        assert ckpt.dtype == torch.float32 and ckpt.shape == (1, 2, 2, 32, 32)

    def test_any_sequence_length_is_taken(self):
        """The reference's ``S % 64`` gate for the Pallas kernel is not
        carried over: the kernels mask the ragged tile."""
        r, k, v, w, u = self._args(S=37)
        out, st = ops.wkv6(r, k, v, w, u, impl="kernel")
        want, ws = tref.wkv6(r, k, v, w, u)
        assert float((out - want).abs().max()) < 1e-5 and float((st - ws).abs().max()) < 1e-5

    def test_cases_the_kernel_does_not_take_raise(self):
        r, k, v, w, u = self._args()
        bad = [
            ((r.half(), k.half(), v.half(), w.half(), u), "dtype"),
            ((r, k.to(torch.bfloat16), v, w, u), "one dtype"),
            ((r, k, v, w, u.to(torch.bfloat16)), "u"),
            ((r, k, v, w, u[:1]), "u"),
            ((r[..., :16].contiguous(), k[..., :16].contiguous(), v[..., :16].contiguous(),
              w[..., :16].contiguous(), u[:, :16].contiguous()), "head dim"),
            ((r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u), "contiguous"),
            ((r[0], k[0], v[0], w[0], u), "B, S, H, hd"),
            ((r[:, :0], k[:, :0], v[:, :0], w[:, :0], u), ">= 1"),
        ]
        for args, match in bad:
            with pytest.raises(ValueError, match=match):
                wk.fwd(*args)
        with pytest.raises(ValueError, match="state"):
            wk.fwd(r, k, v, w, u, torch.zeros(1, 2, 32, 16))
        with pytest.raises(ValueError, match="checkpoints"):
            wk.bwd(r, k, v, w, u, None, r)
        with pytest.raises(ValueError, match="ckpt"):
            wk.bwd(r, k, v, w, u, torch.zeros(1, 2, 2, 32, 32), r)

    def test_unknown_impl_raises(self):
        r, k, v, w, u = self._args()
        with pytest.raises(ValueError, match="impl"):
            ops.wkv6(r, k, v, w, u, impl="pallas")

    def test_importing_builds_nothing(self):
        assert wk._lib is None
