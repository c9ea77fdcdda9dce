"""Dense decoder with grouped-query attention, float32 (InternLM2's block).

Per layer, pre-norm residual: RMSNorm (gain ``1 + scale``), q / k / v
projections (H query heads on K kv heads; query head h reads kv head
h // (H / K)), rotary embedding in the split-halves form at positions
0..S-1, causal softmax attention scaled by 1 / sqrt(hd), the output
projection; RMSNorm, then the gated MLP ``(x wi) * silu(x wg)`` and ``wo``.
A final RMSNorm and an untied head give the logits.  Attention runs
``ATTN_BLOCK`` queries at a time against the keys up to the block's end, each
block recomputed in the backward pass, and each layer is recomputed too, so
a 16 384-token sequence fits beside the optimizer state."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.common import cross_entropy_sum, pick, rms_norm

ATTN_BLOCK = 512


def layout(c: dict) -> list[tuple]:
    d, H, K, ff, V, L = (c["d_model"], c["num_heads"], c["num_kv_heads"], c["d_ff"],
                         c["vocab_size"], c["num_layers"])
    hd = d // H
    bf, f32 = c["dtype"], "float32"
    rows = [(("embedding",), (V, d), bf, 0.0, d ** -0.5),
            (("final_norm", "scale"), (d,), f32, 0.0, 0.0),
            (("lm_head",), (d, V), bf, 0.0, d ** -0.5)]
    unit = [(("norm1", "scale"), (L, d), f32, 0.0, 0.0),
            (("attn", "wq"), (L, d, H, hd), bf, 0.0, d ** -0.5),
            (("attn", "wk"), (L, d, K, hd), bf, 0.0, d ** -0.5),
            (("attn", "wv"), (L, d, K, hd), bf, 0.0, d ** -0.5),
            (("attn", "wo"), (L, H, hd, d), bf, 0.0, (H * hd) ** -0.5),
            (("norm2", "scale"), (L, d), f32, 0.0, 0.0),
            (("mlp", "wi"), (L, d, ff), bf, 0.0, d ** -0.5),
            (("mlp", "wg"), (L, d, ff), bf, 0.0, d ** -0.5),
            (("mlp", "wo"), (L, ff, d), bf, 0.0, ff ** -0.5)]
    return rows + [(("units", "b0") + path, *rest) for path, *rest in unit]


def rope(x, theta: float):
    """x (S, heads, hd) rotated by position, split halves; angles in float64."""
    S, _, hd = x.shape
    freqs = theta ** -(torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos, sin = (t.to(x.dtype)[:, None, :] for t in (torch.cos(ang), torch.sin(ang)))
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, mm):
    """q (S, H, hd), k and v (S, K, hd) -> (S, H, hd)."""
    S, H, hd = q.shape
    K = k.shape[1]
    G = H // K

    def block(qb, kb, vb, start):
        n, end = qb.shape[0], kb.shape[0]
        qh = qb.reshape(n, K, G, hd).permute(1, 2, 0, 3).reshape(K, G * n, hd)
        s = mm(qh, kb.permute(1, 2, 0)) / math.sqrt(hd)                 # (K, G n, end)
        qpos = start + torch.arange(n, device=q.device).repeat(G)
        s = s.masked_fill(torch.arange(end, device=q.device)[None, :] > qpos[:, None],
                          float("-inf"))
        o = mm(torch.softmax(s, -1), vb.permute(1, 0, 2))                # (K, G n, hd)
        return o.reshape(K, G, n, hd).permute(2, 0, 1, 3).reshape(n, H, hd)

    outs = []
    for start in range(0, S, ATTN_BLOCK):
        end = min(start + ATTN_BLOCK, S)
        outs.append(checkpoint(block, q[start:end], k[:end], v[:end], start,
                               use_reentrant=False))
    return torch.cat(outs)


def layer(c: dict, p: dict, x, mm):
    S, d = x.shape
    H, K, eps = c["num_heads"], c["num_kv_heads"], c["rms_norm_eps"]
    hd = d // H
    a = p["attn"]
    h = rms_norm(x, p["norm1"]["scale"], eps)
    q = rope(mm(h, a["wq"].reshape(d, H * hd)).view(S, H, hd), c["rope_theta"])
    k = rope(mm(h, a["wk"].reshape(d, K * hd)).view(S, K, hd), c["rope_theta"])
    v = mm(h, a["wv"].reshape(d, K * hd)).view(S, K, hd)
    o = causal_attention(q, k, v, mm)
    x = x + mm(o.reshape(S, H * hd), a["wo"].reshape(H * hd, d))
    h = rms_norm(x, p["norm2"]["scale"], eps)
    m = p["mlp"]
    return x + mm(mm(h, m["wi"]) * F.silu(mm(h, m["wg"])), m["wo"])


def row_loss(c: dict, params: dict, tokens, labels, mm):
    x = params["embedding"][tokens]
    for u in range(c["num_layers"]):
        x = checkpoint(layer, c, pick(params["units"]["b0"], u), x, mm, use_reentrant=False)
    x = rms_norm(x, params["final_norm"]["scale"], c["rms_norm_eps"])
    return cross_entropy_sum(x, params["lm_head"], labels, mm)
