"""Analytic FLOPs / bytes model for the assigned transformer
architectures — the MODEL_FLOPS side of the roofline: a copy of
:mod:`repro.core.archcost` over the port's
:class:`~repro_torch.models.common.ModelConfig` (exact for matmuls;
elementwise ignored).  The ``llm:`` workload provider slices its
per-block costs out of :func:`block_cost_table`; the dry run
(:mod:`repro_torch.launch.dryrun`) records :func:`step_cost` as each
record's ``analytic`` part.

Conventions: FLOPs are multiply-accumulate*2.  Backward = 2x forward.
Attention terms use 4*S*ctx*H*hd per layer forward (QK^T + PV);
sliding-window layers replace ctx with min(S, window); MoE counts only
routed-active + shared expert parameters (6*N_active*D).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.shapes import InputShape
from repro_torch.models.common import ModelConfig


@dataclass(frozen=True)
class StepCost:
    flops: float              # global flops for one step
    hbm_bytes: float          # global HBM traffic estimate
    model_flops: float        # 6*N*D (train) or 2*N*D (inference)
    param_bytes: float
    n_params: float
    n_active_params: float


def _block_params(cfg: ModelConfig, kind: str) -> tuple[float, float]:
    """(total, active) parameter count of one block of ``kind``."""
    d, hd = cfg.d_model, cfg.head_size
    H, K = cfg.num_heads, cfg.kv_heads
    attn = d * H * hd + 2 * d * K * hd + H * hd * d
    if cfg.num_experts:
        e = cfg.num_experts * 3 * d * cfg.moe_d_ff
        e_active = cfg.experts_per_token * 3 * d * cfg.moe_d_ff
        shared = 3 * d * cfg.shared_expert_d_ff if cfg.shared_expert_d_ff else 0
        router = d * cfg.num_experts
        ffn, ffn_active = e + shared + router, e_active + shared + router
    else:
        n_mats = 3 if cfg.mlp_gated else 2
        ffn = ffn_active = n_mats * d * cfg.d_ff
    if kind in ("G", "L"):
        return attn + ffn, attn + ffn_active
    if kind == "C":
        return 2 * attn + ffn, 2 * attn + ffn_active
    if kind == "R":
        W = cfg.rnn_size
        rec = 2 * d * W + 2 * W * W + W * d + cfg.conv1d_width * W
        return rec + ffn, rec + ffn_active
    if kind == "W":
        tm = 6 * d * d                  # r,k,v,w,g,o projections
        cm = d * cfg.d_ff * 2 + d * d
        return tm + cm, tm + cm
    raise ValueError(kind)


def _pattern_of(cfg: ModelConfig) -> str:
    return (cfg.layer_pattern * cfg.num_units) + cfg.remainder_pattern


def param_counts(cfg: ModelConfig) -> tuple[float, float]:
    total = active = cfg.vocab_size * cfg.d_model   # embedding
    if not cfg.tie_embeddings:
        total += cfg.d_model * cfg.vocab_size
        active += cfg.d_model * cfg.vocab_size
    for kind in _pattern_of(cfg):
        t, a = _block_params(cfg, kind)
        total, active = total + t, active + a
    if cfg.arch_type == "audio":
        d = cfg.d_model
        enc_block = 4 * d * d + 2 * d * cfg.d_ff
        total += cfg.encoder_layers * enc_block
        active += cfg.encoder_layers * enc_block
    return float(total), float(active)


def _attn_ctx(cfg: ModelConfig, kind: str, S: int) -> float:
    if kind == "L" and cfg.sliding_window:
        return float(min(S, cfg.sliding_window))
    if kind == "C":
        return float(cfg.encoder_seq or cfg.num_image_tokens or S)
    return float(S)


def _attention_flops_fwd(cfg: ModelConfig, S: int, B: int) -> float:
    """Score+value matmul flops for one full forward over (B, S)."""
    H, hd = cfg.num_heads, cfg.head_size
    total = 0.0
    for kind in _pattern_of(cfg):
        if kind == "G":
            # causal: average context S/2
            total += 2.0 * B * S * S * H * hd
        elif kind == "L":
            total += 4.0 * B * S * _attn_ctx(cfg, kind, S) * H * hd
        elif kind == "C":
            # self (causal) + cross over encoder tokens
            total += 2.0 * B * S * S * H * hd
            total += 4.0 * B * S * _attn_ctx(cfg, kind, S) * H * hd
        elif kind == "W":
            total += 4.0 * B * S * hd * cfg.d_model    # state updates per token
        elif kind == "R":
            total += 8.0 * B * S * cfg.rnn_size        # elementwise recurrence
    return total


@dataclass(frozen=True)
class BlockCost:
    """One DAG layer of an ``llm:`` workload: the embedding, one
    pattern block, one audio-encoder block, or the untied LM head."""

    name: str
    flops_fwd: float          # forward flops for ONE sequence of seq_len tokens
    params: float             # total learnable params (gradient payload)
    active_params: float      # per-token-active params (compute source)


def _block_attn_flops_fwd(cfg: ModelConfig, kind: str, S: int) -> float:
    """Score+value matmul forward flops of one block for one sequence —
    the per-block slice of :func:`_attention_flops_fwd` (B=1)."""
    H, hd = cfg.num_heads, cfg.head_size
    if kind == "G":
        return 2.0 * S * S * H * hd
    if kind == "L":
        return 4.0 * S * _attn_ctx(cfg, kind, S) * H * hd
    if kind == "C":
        return 2.0 * S * S * H * hd + 4.0 * S * _attn_ctx(cfg, kind, S) * H * hd
    if kind == "W":
        return 4.0 * S * hd * cfg.d_model
    if kind == "R":
        return 8.0 * S * cfg.rnn_size
    raise ValueError(kind)


def block_cost_table(cfg: ModelConfig, seq_len: int) -> list[BlockCost]:
    """Slice the architecture into per-block layer costs — the
    ``llm:`` workload provider's cost source.

    Follows :func:`param_counts` / :func:`step_cost` exactly: every
    parameter matrix contributes ``2 * active_params * seq_len`` forward
    matmul flops per sequence (embeddings included, per the 6ND
    convention) plus the block kind's attention term, so

    * ``sum(params)`` == ``param_counts(cfg)[0]``,
    * ``sum(active_params)`` == ``param_counts(cfg)[1]``,
    * ``3 * B * sum(flops_fwd)`` == ``step_cost(cfg, train).flops``
      when the shapes' ``seq_len`` match (train = 3x forward).
    """
    S = seq_len
    emb = float(cfg.vocab_size * cfg.d_model)
    table = [BlockCost("embed", 2.0 * emb * S, emb, emb)]
    for i, kind in enumerate(_pattern_of(cfg)):
        total, active = _block_params(cfg, kind)
        table.append(BlockCost(
            f"block{i}_{kind}",
            2.0 * active * S + _block_attn_flops_fwd(cfg, kind, S),
            float(total), float(active)))
    if cfg.arch_type == "audio":
        d = cfg.d_model
        enc = float(4 * d * d + 2 * d * cfg.d_ff)
        for j in range(cfg.encoder_layers):
            table.append(BlockCost(f"enc{j}", 2.0 * enc * S, enc, enc))
    if not cfg.tie_embeddings:
        table.append(BlockCost("lm_head", 2.0 * emb * S, emb, emb))
    return table


def step_cost(cfg: ModelConfig, shape: InputShape) -> StepCost:
    B, S = shape.global_batch, shape.seq_len
    n_total, n_active = param_counts(cfg)
    pbytes = 2.0 * n_total                              # bf16
    if shape.kind == "train":
        D = B * S
        matmul = 6.0 * n_active * D
        attn = 3.0 * _attention_flops_fwd(cfg, S, B)
        flops = matmul + attn
        model_flops = 6.0 * n_active * D
        # params read fwd+bwd (bf16) + grads written + SGD-momentum
        # update (f32 m read/write + param read/write)
        hbm = 2 * pbytes + pbytes + 12.0 * n_total \
            + 20.0 * D * cfg.d_model * len(_pattern_of(cfg))
    elif shape.kind == "prefill":
        D = B * S
        flops = 2.0 * n_active * D + _attention_flops_fwd(cfg, S, B)
        model_flops = 2.0 * n_active * D
        hbm = pbytes + 4.0 * D * cfg.d_model * len(_pattern_of(cfg))
    else:  # decode: one token per sequence, cache of length S
        D = B
        flops = 2.0 * n_active * D
        cache_bytes = 0.0
        for kind in _pattern_of(cfg):
            if kind in ("G", "C"):
                ctx = S
            elif kind == "L":
                ctx = min(S, cfg.sliding_window or S)
            else:
                ctx = 0
            if ctx:
                flops += 4.0 * B * ctx * cfg.num_heads * cfg.head_size
                cache_bytes += 2.0 * B * ctx * cfg.kv_heads * cfg.head_size * 2
            if kind == "W":
                hd = 64
                H = cfg.d_model // hd
                flops += 4.0 * B * H * hd * hd
                cache_bytes += 4.0 * B * H * hd * hd
            if kind == "R":
                flops += 8.0 * B * cfg.rnn_size
                cache_bytes += 4.0 * B * cfg.rnn_size
        model_flops = 2.0 * n_active * D
        hbm = pbytes + cache_bytes                     # read params + cache
    return StepCost(flops=flops, hbm_bytes=hbm, model_flops=model_flops,
                    param_bytes=pbytes, n_params=n_total,
                    n_active_params=n_active)
