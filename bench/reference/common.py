"""What both reference families share: the matrix products (float32, and
the float8 control's), norms, and a token-blocked cross-entropy."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
FP8_MAX = {E4M3: 448.0, E5M2: 57344.0}


def f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def fp8_round(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` through ``dtype`` with one scale for the whole tensor (its
    largest magnitude maps to the format's largest), back in float32."""
    scale = FP8_MAX[dtype] / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).float() / scale


class _FP8MM(torch.autograd.Function):
    """a @ b with both operands rounded to e4m3, and the backward's
    products with the incoming gradient rounded to e5m2: the usual float8
    training recipe, accumulated in float32."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8_round(a, E4M3), fp8_round(b, E4M3)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(g, E5M2)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _FP8MM.apply(a, b)


#: the reference's matrix product, and its float8 control's
MATMULS = {"f32": f32_mm, "fp8": fp8_mm}


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def layer_norm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def pick(tree, u: int):
    """Layer ``u``'s parameters from a tree whose stacked leaves are lists."""
    if isinstance(tree, dict):
        return {k: pick(v, u) for k, v in tree.items()}
    return tree[u] if isinstance(tree, list) else tree


def cross_entropy_sum(x, head, labels, mm, block: int = 2048):
    """Summed cross-entropy of the logits ``x @ head`` (S, V) against
    ``labels`` (S,), ``block`` tokens at a time, each block recomputed in the
    backward pass so no more than one block's logits live at once."""
    def part(xb, lb):
        logits = mm(xb, head)
        return (torch.logsumexp(logits, -1)
                - logits.gather(-1, lb[:, None])[:, 0]).sum()

    return sum(checkpoint(part, x[i:i + block], labels[i:i + block], use_reentrant=False)
               for i in range(0, x.shape[0], block))
