"""Shared model vocabulary: config dataclass, norms, RoPE, init helpers.

Counterpart of :mod:`repro.models.common`.  :class:`ModelConfig` has the
same fields, properties, ``validate()`` and ``reduced()`` rules, with the
dtypes mapped to torch (``jnp.bfloat16`` -> ``torch.bfloat16``,
``jnp.float32`` -> ``torch.float32``).

Block kind characters:
  ``G`` global self-attention      ``L`` local (sliding-window) self-attention
  ``R`` RG-LRU recurrent block     ``W`` RWKV6 time-mix + channel-mix block
  ``C`` cross-attention block (self-attn + cross-attn + mlp)
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import torch

Params = Any      # nested dict of tensors, keyed like the JAX pytree


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                     # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    vocab_size: int
    num_kv_heads: int | None = None
    head_dim: int | None = None
    qkv_bias: bool = False
    mlp_gated: bool = True             # SwiGLU; False = GELU MLP (whisper)
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    layer_pattern: str = "G"
    sliding_window: int | None = None  # tokens, for 'L' blocks
    rope_theta: float = 10_000.0
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 512
    # --- recurrent (R/W blocks) ---
    rnn_width: int = 0
    conv1d_width: int = 4
    # --- encoder-decoder / VLM ---
    encoder_layers: int = 0
    encoder_seq: int = 0
    encoder_d_model: int = 0
    num_image_tokens: int = 0
    # --- numerics ---
    dtype: Any = torch.bfloat16
    logit_dtype: Any = torch.float32
    tie_embeddings: bool = False
    source: str = ""

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_size(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def rnn_size(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def pattern_unit(self) -> str:
        return self.layer_pattern

    @property
    def num_units(self) -> int:
        return self.num_layers // len(self.layer_pattern)

    @property
    def remainder_pattern(self) -> str:
        """Layers that do not fill a whole pattern unit (prefix order)."""
        return self.layer_pattern[: self.num_layers % len(self.layer_pattern)]

    @property
    def is_subquadratic(self) -> bool:
        return self.arch_type in ("ssm", "hybrid") or "G" not in self.layer_pattern \
            or self.arch_type == "dense" and self.sliding_window is not None

    def validate(self) -> "ModelConfig":
        if self.num_layers < len(self.remainder_pattern):
            raise ValueError("num_layers smaller than pattern remainder")
        if self.num_heads % self.kv_heads:
            raise ValueError(f"{self.name}: num_heads {self.num_heads} not a "
                             f"multiple of kv heads {self.kv_heads}")
        if self.num_experts and not self.experts_per_token:
            raise ValueError("MoE needs experts_per_token")
        for ch in self.layer_pattern:
            if ch not in "GLRWC":
                raise ValueError(f"unknown block kind {ch!r}")
        return self

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                num_heads: int = 4, d_ff: int = 512, vocab_size: int = 512,
                num_experts: int | None = None, **over) -> "ModelConfig":
        """Smoke-test variant of the same family (same rules as the
        reference's ``ModelConfig.reduced``)."""
        kv = max(1, min(self.kv_heads, num_heads))
        ne = min(self.num_experts, 4) if num_experts is None else num_experts
        changes: dict[str, Any] = dict(
            name=self.name + "-reduced",
            num_layers=num_layers, d_model=d_model, num_heads=num_heads,
            num_kv_heads=kv if self.num_kv_heads else None,
            head_dim=d_model // num_heads if self.head_dim else None,
            d_ff=d_ff, vocab_size=vocab_size,
            num_experts=ne,
            experts_per_token=min(self.experts_per_token, max(ne, 1)) if ne else 0,
            moe_d_ff=min(self.moe_d_ff, d_ff) if ne else 0,
            shared_expert_d_ff=min(self.shared_expert_d_ff, d_ff),
            rnn_width=min(self.rnn_size, d_model) if self.rnn_width else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 64) if self.encoder_seq else 0,
            encoder_d_model=min(self.encoder_d_model, d_model) if self.encoder_d_model else 0,
            num_image_tokens=min(self.num_image_tokens, 16),
            moe_group_size=64,
            dtype=torch.float32, logit_dtype=torch.float32,
            layer_pattern="".join(dict.fromkeys(self.layer_pattern))[:num_layers]
            if len(self.layer_pattern) > num_layers else self.layer_pattern,
        )
        changes.update(over)
        return dataclasses.replace(self, **changes).validate()


# ----------------------------------------------------------------------
# Numerics
# ----------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def init_norm(cfg: ModelConfig, device, lead: tuple[int, ...] = ()) -> Params:
    """Norm parameters in float32, as the reference keeps them."""
    shape = (*lead, cfg.d_model)
    if cfg.norm == "rmsnorm":
        return {"scale": torch.zeros(shape, dtype=torch.float32, device=device)}
    return {"scale": torch.ones(shape, dtype=torch.float32, device=device),
            "bias": torch.zeros(shape, dtype=torch.float32, device=device)}


# ----------------------------------------------------------------------
# RoPE (split-halves form)
# ----------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # (hd/2,)
    angles = positions[..., :, None].float() * freqs              # (..., S, hd/2)
    angles = angles[..., None, :]                                 # (..., S, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# Init helpers
# ----------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape: tuple[int, ...], dtype, device,
               in_axis_size: int | None = None) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights; ``fan_in`` defaults to ``shape[0]``
    (pass it when ``shape`` carries a leading unit axis)."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * std).to(dtype)
