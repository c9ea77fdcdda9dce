"""Why the tensor-core flash kernels split P (and dS) into two bfloat16
values, pinned on the CPU.

The bfloat16 kernels ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkdv``
take their second products (O = P V in the forward; dV += P^T dO, dK +=
dS^T Q, dQ += dS K in the backward) on the tensor cores, whose operands are
bfloat16.  ``plain_fwd(..., rounding=...)`` and ``plain_bwd(...,
rounding=...)`` emulate the two ways P and dS can enter them, in float32 on
bfloat16-valued inputs, against the same sums with P and dS in float32
(what the kernels are held to on the card): rounded once to bfloat16 they
read far over the bfloat16 check's limit, |err| <= 1e-2 |want| + 1e-3
rms(want) (``chip_smoke.py`` ``LIMITS``); as a hi + lo pair they stay
within one rounding step of the output.  Inputs: recurrentgemma-2b's
local-attention shape cut to B 1, S 256, H 4 (one kv head, hd 256), and
qwen1.5-4b's cut to B 1, S 256, H 4 (hd 128), from numpy seeds.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

LIMIT = (1e-2, 1e-3)   # chip_smoke.py LIMITS[torch.bfloat16]
SHAPES = {"l_block": (1, 256, 4, 1, 256), "slice": (1, 256, 4, 4, 128)}
OUTPUTS = ("dq", "dk", "dv")


def _inputs(B, S, H, K, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32)).to(torch.bfloat16)
            for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd), (B, S, H, hd))]


def _of_limit(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst entry's error over its limit."""
    g, w = got.float(), want.float()
    limit = LIMIT[0] * w.abs() + LIMIT[1] * w.square().mean().sqrt()
    return float(((g - w).abs() / limit.clamp_min(1e-30)).max())


def _fwd_reading(shape, seed, rounding):
    """o with the unnormalised P rounded as ``rounding``, against o with P
    in float32."""
    q, k, v, _ = _inputs(*SHAPES[shape], seed)
    want, _ = fa.plain_fwd(q, k, v, True, None)
    got, _ = fa.plain_fwd(q, k, v, True, None, rounding=rounding)
    return _of_limit(got, want)


def _readings(shape, seed, rounding):
    q, k, v, do = _inputs(*SHAPES[shape], seed)
    o, lse = fa.plain_fwd(q, k, v, True, None)
    delta = fa.plain_bwd_delta(o, do)
    want = fa.plain_bwd(q, k, v, do, lse, delta, True, None)
    got = fa.plain_bwd(q, k, v, do, lse, delta, True, None, rounding=rounding)
    return dict(zip(OUTPUTS, (_of_limit(g, w) for g, w in zip(got, want))))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("out", OUTPUTS)
def test_rounding_once_breaks_the_bf16_limit(out, shape, seed):
    """P and dS rounded once to bfloat16: over the limit (6-13x here)."""
    assert _readings(shape, seed, "bf16")[out] > 1.0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("out", OUTPUTS)
def test_hi_lo_split_keeps_the_bf16_limit(out, shape, seed):
    """P and dS as hi + lo: under 0.8 of the limit (0.60-0.76 here), the
    output's own rounding step."""
    assert _readings(shape, seed, "split")[out] < 0.8


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_rounding_p_once_breaks_the_bf16_limit(shape, seed):
    """exp(s - m) rounded once to bfloat16 before O = P V: over the limit
    (5.9-6.8x here)."""
    assert _fwd_reading(shape, seed, "bf16") > 1.0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_hi_lo_split_keeps_the_bf16_limit(shape, seed):
    """exp(s - m) as hi + lo: under 0.8 of the limit (0.66-0.71 here)."""
    assert _fwd_reading(shape, seed, "split") < 0.8


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_f32_rounding_is_the_plain_forward(shape, seed):
    """``rounding="f32"`` (the default) is the softmax-then-product the
    kernels are held to, bit for bit."""
    q, k, v, _ = _inputs(*SHAPES[shape], seed)
    B, S, H, hd = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / math.sqrt(hd)),
                     fa.repeat_kv(k.float(), H // k.shape[2]))
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    s = s.masked_fill(~mask, fa.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    lc = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    want = torch.einsum("bhqk,bkhd->bqhd", p / lc, fa.repeat_kv(v.float(), H // v.shape[2]))
    o, lse = fa.plain_fwd(q, k, v, True, None, rounding="f32")
    assert torch.equal(o, want.to(q.dtype))
    assert torch.equal(lse, (m + torch.log(lc)).squeeze(-1))
    assert torch.equal(o, fa.plain_fwd(q, k, v, True, None)[0])


def test_round_operand():
    x = torch.tensor([1.0 + 2.0 ** -12, 0.3, -7.1e-3, 0.0])
    assert torch.equal(fa.round_operand(x, "f32"), x)
    once = fa.round_operand(x, "bf16")
    assert torch.equal(once, x.to(torch.bfloat16).float())
    split = fa.round_operand(x, "split")
    assert float((split - x).abs().max()) < float((once - x).abs().max())
    assert float(((split - x).abs() / x.abs().clamp_min(1e-30)).max()) < 2.0 ** -15
    with pytest.raises(ValueError, match="rounding"):
        fa.round_operand(x, "fp8")


@pytest.mark.parametrize("H,K", [(4, 1), (8, 2), (4, 4)])
def test_group_partial_sum_matches_plain_bwd(H, K):
    """The partials the bf16 ``flash_bwd_dkdv`` writes per query head,
    summed by the wrapper's :func:`sum_groups`, give ``plain_bwd``'s dk and
    dv (float32 inputs, so nothing rounds on the way)."""
    B, S, hd = 2, 64, 32
    rng = np.random.default_rng(3)
    q, do = (torch.from_numpy(rng.standard_normal((B, S, H, hd), np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, K, hd), np.float32)) for _ in range(2))
    o, lse = fa.plain_fwd(q, k, v, True, 24)
    delta = fa.plain_bwd_delta(o, do)
    _, dk, dv = fa.plain_bwd(q, k, v, do, lse, delta, True, 24)
    # each query head's own dk/dv: that head alone against its kv head
    G = H // K
    part_k, part_v = torch.empty(B, S, H, hd), torch.empty(B, S, H, hd)
    for h in range(H):
        sl = slice(h, h + 1)
        kv = slice(h // G, h // G + 1)
        _, pk, pv = fa.plain_bwd(q[:, :, sl].contiguous(), k[:, :, kv].contiguous(),
                                 v[:, :, kv].contiguous(), do[:, :, sl].contiguous(),
                                 lse[:, sl].contiguous(), delta[:, sl].contiguous(), True, 24)
        part_k[:, :, h], part_v[:, :, h] = pk[:, :, 0], pv[:, :, 0]
    torch.testing.assert_close(fa.sum_groups(part_k, K), dk, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fa.sum_groups(part_v, K), dv, rtol=1e-5, atol=1e-5)
