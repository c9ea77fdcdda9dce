"""Memory-efficient chunked attention: the FlashAttention-2 schedule in
plain PyTorch, with its own backward.

Counterpart of :mod:`repro.kernels.chunked_attention` (``chunked_attention``
and its ``custom_vjp``, the forward ``_chunked_fwd`` and the backward
``_vjp_bwd``).  The plain attention (:func:`repro_torch.kernels.ref.attention`)
materialises the (B, H, S, S) f32 scores: 64 MiB for each (b, h) at 4096
tokens.  Here the forward walks the kv blocks of each q block with an
online softmax (f32 running max, sum and accumulator) and saves only the
output and the logsumexp beside its inputs; the backward recomputes each
(block_q x block_k) block's scores from them.  Neither pass holds more
than one block's scores per (b, h).

Like the reference's, this is not a kernel: it is plain torch on whatever
device its tensors are on, as the reference's is plain ``jnp`` outside any
Pallas kernel.  :func:`repro_torch.kernels.ops.attention` sends CPU
self-attention at S >= ``CHUNKED_ATTENTION_MIN_SEQ`` here, as the
reference does; CUDA and meta tensors keep the flash kernels.

Shapes follow the model layout: q (B, S, H, hd), k and v (B, S, K, hd).
GQA runs grouped: a q block is (B, K, G, bq, hd) with G = H // K, and k and
v are never expanded to H heads (the reference repeats them; the sums are
the same).  Masks: causal (kv position <= q position) and the sliding
window (kv position > q position - window); masked scores are
``NEG_INF``.  A block that the masks hide whole is skipped, which changes
no value: its probabilities are all 0 and its rescale factor 1.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
DEFAULT_BLOCK = 512


def _visible(q0: int, bq: int, k0: int, bk: int, causal: bool, window) -> bool:
    """Whether any (q, kv) pair of the two blocks passes the masks."""
    if causal and k0 > q0 + bq - 1:
        return False
    if window is not None and k0 + bk - 1 <= q0 - window:
        return False
    return True


def _mask(q0: int, bq: int, k0: int, bk: int, causal: bool, window, device):
    """(bq, bk) bool, or None where every pair passes."""
    if causal and k0 + bk - 1 <= q0 and (window is None or k0 > q0 + bq - 1 - window):
        return None
    if not causal and window is None:
        return None
    qp = torch.arange(q0, q0 + bq, device=device)[:, None]
    kp = torch.arange(k0, k0 + bk, device=device)[None, :]
    m = torch.ones(bq, bk, dtype=torch.bool, device=device)
    if causal:
        m &= kp <= qp
    if window is not None:
        m &= kp > qp - window
    return m


def _q_blocks(x: torch.Tensor, K: int, bq: int) -> torch.Tensor:
    """(B, S, H, *r) -> (nq, B, K, G, bq, *r) in f32."""
    B, S, H = x.shape[:3]
    rest = x.shape[3:]
    y = x.float().reshape(B, S // bq, bq, K, H // K, *rest)
    return y.permute(1, 0, 3, 4, 2, *range(5, 5 + len(rest)))


def _q_unblock(x: torch.Tensor) -> torch.Tensor:
    """(nq, B, K, G, bq, *r) -> (B, S, H, *r)."""
    nq, B, K, G, bq = x.shape[:5]
    rest = x.shape[5:]
    y = x.permute(1, 0, 4, 2, 3, *range(5, 5 + len(rest)))
    return y.reshape(B, nq * bq, K * G, *rest)


def _kv_blocks(x: torch.Tensor, bk: int) -> torch.Tensor:
    """(B, S, K, hd) -> (nk, B, K, bk, hd) in f32."""
    B, S, K, hd = x.shape
    return x.float().reshape(B, S // bk, bk, K, hd).permute(1, 0, 3, 2, 4)


def _kv_unblock(x: torch.Tensor) -> torch.Tensor:
    """(nk, B, K, bk, hd) -> (B, S, K, hd)."""
    nk, B, K, bk, hd = x.shape
    return x.permute(1, 0, 3, 2, 4).reshape(B, nk * bk, K, hd)


def _blocks(S: int, block_q: int, block_k: int) -> tuple[int, int]:
    bq, bk = min(block_q, S), min(block_k, S)
    if S % bq or S % bk:
        raise ValueError(f"S={S} must be a multiple of blocks {bq}/{bk}")
    return bq, bk


def chunked_fwd(q, k, v, causal: bool = True, window=None,
                block_q: int = DEFAULT_BLOCK, block_k: int = DEFAULT_BLOCK):
    """(out (B, S, H, hd) in q's dtype, lse (B, S, H) f32)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    bq, bk = _blocks(S, block_q, block_k)
    scale = 1.0 / math.sqrt(hd)
    qb = _q_blocks(q, K, bq)                                   # (nq, B, K, G, bq, hd)
    kb, vb = _kv_blocks(k, bk), _kv_blocks(v, bk)              # (nk, B, K, bk, hd)
    outs, lses = [], []
    for iq in range(S // bq):
        qi = qb[iq]
        m_run = torch.full(qi.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
        l_run = torch.zeros_like(m_run)
        acc = torch.zeros_like(qi)
        for ik in range(S // bk):
            if not _visible(iq * bq, bq, ik * bk, bk, causal, window):
                continue
            s = (qi @ kb[ik].transpose(-1, -2)[:, :, None]) * scale   # (B, K, G, bq, bk)
            msk = _mask(iq * bq, bq, ik * bk, bk, causal, window, q.device)
            if msk is not None:
                s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            if msk is not None:
                p = torch.where(msk, p, 0.0)
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p @ vb[ik][:, :, None]
            m_run = m_new
        l_safe = torch.clamp(l_run, min=1e-30)
        outs.append(acc / l_safe[..., None])
        lses.append(m_run + torch.log(l_safe))
    out = _q_unblock(torch.stack(outs))
    lse = _q_unblock(torch.stack(lses))
    return out.to(q.dtype), lse


def chunked_bwd(q, k, v, out, lse, dout, causal: bool = True, window=None,
                block_q: int = DEFAULT_BLOCK, block_k: int = DEFAULT_BLOCK):
    """(dq, dk, dv) in the dtypes of q, k and v.  Each visible block's
    scores are recomputed once and feed dq, dk and dv together."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    bq, bk = _blocks(S, block_q, block_k)
    scale = 1.0 / math.sqrt(hd)
    qb, dob, outb = (_q_blocks(t, K, bq) for t in (q, dout, out))
    lseb = _q_blocks(lse, K, bq)                               # (nq, B, K, G, bq)
    delta = (dob * outb).sum(dim=-1)                           # (nq, B, K, G, bq)
    kb, vb = _kv_blocks(k, bk), _kv_blocks(v, bk)
    dq, dk, dv = torch.zeros_like(qb), torch.zeros_like(kb), torch.zeros_like(vb)
    for iq in range(S // bq):
        qi, doi, li, di = qb[iq], dob[iq], lseb[iq], delta[iq]
        for ik in range(S // bk):
            if not _visible(iq * bq, bq, ik * bk, bk, causal, window):
                continue
            kj, vj = kb[ik][:, :, None], vb[ik][:, :, None]     # (B, K, 1, bk, hd)
            s = (qi @ kj.transpose(-1, -2)) * scale               # (B, K, G, bq, bk)
            p = torch.exp(s - li[..., None])
            msk = _mask(iq * bq, bq, ik * bk, bk, causal, window, q.device)
            if msk is not None:
                p = torch.where(msk, p, 0.0)
            dv[ik] += (p.transpose(-1, -2) @ doi).sum(dim=2)
            dp = doi @ vj.transpose(-1, -2)
            ds = p * (dp - di[..., None]) * scale
            dq[iq] += ds @ kj
            dk[ik] += (ds.transpose(-1, -2) @ qi).sum(dim=2)
    return (_q_unblock(dq).to(q.dtype), _kv_unblock(dk).to(k.dtype),
            _kv_unblock(dv).to(v.dtype))


class ChunkedAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: saves q, k, v, the output and the
    logsumexp; the backward recomputes the block scores."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_q, block_k):
        out, lse = chunked_fwd(q, k, v, causal, window, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, window, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = chunked_bwd(q, k, v, out, lse, dout, *ctx.cfg)
        return dq, dk, dv, None, None, None, None


def chunked_attention(q, k, v, causal: bool = True, window=None,
                      block_q: int = DEFAULT_BLOCK, block_k: int = DEFAULT_BLOCK):
    """q (B, S, H, hd), k and v (B, S, K, hd) -> (B, S, H, hd) in q's dtype."""
    return ChunkedAttention.apply(q, k, v, causal, window, block_q, block_k)
