"""FLOPs a training step's forward and backward need, by the program's
analytic convention (``core/archcost.step_cost``, frozen here): 6 x the
parameters x the tokens, embedding and head included, plus 3 x the forward's
attention term, which counts a causal mask at half the pairs (2 B S^2 H hd a
global-attention layer) and a wkv6 layer at 4 B S hd d.  Nothing recomputed
is counted."""
from __future__ import annotations


def _block_params(c: dict) -> float:
    d, ff = c["d_model"], c["d_ff"]
    if c["layer_pattern"] == "W":
        return 6 * d * d + 2 * d * ff + d * d
    H, K = c["num_heads"], c.get("num_kv_heads") or c["num_heads"]
    hd = c.get("head_dim") or d // H
    attn = d * H * hd + 2 * d * K * hd + H * hd * d
    return attn + (3 if c.get("mlp_gated", True) else 2) * d * ff


def n_params(c: dict) -> float:
    """Embedding, head (when untied) and every layer's matrices."""
    emb = c["vocab_size"] * c["d_model"] * (1 if c.get("tie_embeddings") else 2)
    return float(emb + c["num_layers"] * _block_params(c))


def train_step_flops(c: dict, rows: int, seq: int) -> float:
    """FLOPs of one training step over ``rows`` sequences of ``seq`` tokens."""
    d, H = c["d_model"], c["num_heads"]
    hd = c.get("head_dim") or d // H
    if c["layer_pattern"] == "W":
        attn = 4.0 * rows * seq * hd * d
    else:
        attn = 2.0 * rows * seq * seq * H * hd
    return 6.0 * n_params(c) * rows * seq + 3.0 * c["num_layers"] * attn
