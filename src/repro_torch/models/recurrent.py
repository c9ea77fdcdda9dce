"""The Griffin recurrent block (RecurrentGemma): input projections, the
depthwise causal conv, the RG-LRU scan and the gated output.

Counterpart of :mod:`repro.models.recurrent` lines 108-156, train path
only: the carried decode state (``state``) waits for the serving slice, and
the RWKV6 mixers for theirs.  The scan is
:func:`repro_torch.kernels.ops.rglru`: the Hopper kernels on CUDA, the
plain oracle on the CPU.  The numerics follow the reference step for step:
the gate is the tanh-approximated GELU (``jax.nn.gelu``'s default) in f32;
the conv accumulates its taps in f32; ``r_gate`` and ``i_gate`` go through
f32 and back to the conv output's dtype before the scan.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.common import ModelConfig, Params, dense_init


def init_rglru_block(cfg: ModelConfig, gen: torch.Generator, device,
                     lead: tuple[int, ...] = ()) -> Params:
    """``lead`` prepends axes (the stacked unit axis) to every leaf.
    ``lam`` (Lambda) is float32 whatever the model's dtype."""
    d, W = cfg.d_model, cfg.rnn_size
    lam = torch.linspace(0.1, 2.0, W, dtype=torch.float32, device=device)
    return {
        "w_in_x": dense_init(gen, (*lead, d, W), cfg.dtype, device, in_axis_size=d),
        "w_in_gate": dense_init(gen, (*lead, d, W), cfg.dtype, device, in_axis_size=d),
        "conv_w": dense_init(gen, (*lead, cfg.conv1d_width, W), cfg.dtype, device,
                             in_axis_size=cfg.conv1d_width),
        "conv_b": torch.zeros((*lead, W), dtype=cfg.dtype, device=device),
        "w_rgate": dense_init(gen, (*lead, W, W), cfg.dtype, device, in_axis_size=W),
        "w_igate": dense_init(gen, (*lead, W, W), cfg.dtype, device, in_axis_size=W),
        "lam": lam.expand(*lead, W).clone(),
        "w_out": dense_init(gen, (*lead, W, d), cfg.dtype, device, in_axis_size=W),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv; x: (B, S, W); w: (kw, W); b: (W,).  The taps
    are shifted multiply-adds summed in f32 in the reference's order."""
    kw = w.shape[0]
    B, S, W = x.shape
    xp = torch.cat([x.new_zeros(B, kw - 1, W), x], dim=1)
    out = torch.zeros(B, S, W, dtype=torch.float32, device=x.device)
    for i in range(kw):
        out = out + xp[:, i:i + S].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def rglru_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  The reference also returns the final
    scan and conv state, which the train path drops."""
    gate = F.gelu((x @ p["w_in_gate"]).float(), approximate="tanh").to(x.dtype)
    u = _causal_conv1d(x @ p["w_in_x"], p["conv_w"], p["conv_b"])
    r_gate = (u @ p["w_rgate"]).float()
    i_gate = (u @ p["w_igate"]).float()
    y, _ = kops.rglru(u, r_gate.to(u.dtype), i_gate.to(u.dtype), p["lam"])
    return (y * gate) @ p["w_out"]
