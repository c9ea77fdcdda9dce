"""Recurrent blocks: the RWKV6 (Finch) time mix and channel mix, and the
Griffin recurrent block (RecurrentGemma).

Counterpart of :mod:`repro.models.recurrent`.  Each block takes the state
carried from the tokens before (None: a fresh sequence) and returns
``(out, new_state)`` as the reference does: the time mix's wkv state and
last token, the channel mix's last token, the Griffin block's scan state
and the conv's last ``kw - 1`` inputs.  The scans are
:func:`repro_torch.kernels.ops.wkv6` and
:func:`repro_torch.kernels.ops.rglru`: the Hopper kernels on CUDA, the
plain oracles on the CPU.  The numerics follow the reference step for step.
RWKV6: the decay ``exp(-exp(w_raw + w_bias))`` is computed in f32 and cast
to r's dtype before the scan; the per-head group norm is an RMS norm (no
mean, eps 1e-6) in f32 times the f32 ``ln_scale``; the SiLU gate, the
channel mix's squared ReLU and its sigmoid gate are f32, each cast back to
the activations' dtype.  Griffin: the gate is the tanh-approximated GELU
(``jax.nn.gelu``'s default) in f32; the conv accumulates its taps in f32;
``r_gate`` and ``i_gate`` go through f32 and back to the conv output's
dtype before the scan.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.common import ModelConfig, Params, dense_init

# ----------------------------------------------------------------------
# RWKV6: time mix (wkv with data-dependent decay) + channel mix.  Heads of
# size 64, as in the released models.
# ----------------------------------------------------------------------
RWKV_HEAD_DIM = 64


def rwkv_heads(cfg: ModelConfig) -> int:
    if cfg.d_model % RWKV_HEAD_DIM:
        raise ValueError(f"d_model {cfg.d_model} is not a multiple of {RWKV_HEAD_DIM}")
    return cfg.d_model // RWKV_HEAD_DIM


def init_rwkv_time_mix(cfg: ModelConfig, gen: torch.Generator, device,
                       lead: tuple[int, ...] = ()) -> Params:
    """``lead`` prepends axes (the stacked unit axis) to every leaf.
    ``w_bias``, ``u`` and ``ln_scale`` are float32 whatever the model's
    dtype."""
    d, H = cfg.d_model, rwkv_heads(cfg)

    def dense():
        return dense_init(gen, (*lead, d, d), cfg.dtype, device, in_axis_size=d)

    return {
        # token-shift interpolation weights, one per projection: r, k, v, w, g
        "mu": torch.full((*lead, 5, d), 0.5, dtype=cfg.dtype, device=device),
        "wr": dense(), "wk": dense(), "wv": dense(),
        "ww": dense(),                                   # data-dependent decay
        "wg": dense(),
        "w_bias": torch.full((*lead, d), -6.0, dtype=torch.float32, device=device),
        "u": dense_init(gen, (*lead, H, RWKV_HEAD_DIM), torch.float32, device,
                        in_axis_size=H),                 # bonus
        "wo": dense(),
        "ln_scale": torch.ones((*lead, d), dtype=torch.float32, device=device),
    }


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor | None) -> torch.Tensor:
    """x_{t-1} at each t: ``x_prev`` (B, d) before the first token, zeros
    when None (a fresh sequence)."""
    first = torch.zeros_like(x[:, :1]) if x_prev is None else x_prev[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def rwkv_time_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  state: Params | None = None) -> tuple[torch.Tensor, Params]:
    """x: (B, S, d) -> ((B, S, d), {"S": the wkv state (B, H, hd, hd) f32,
    "x_prev": the last token (B, d)}); ``state`` is the same dict carried
    from the tokens before, None for a fresh sequence."""
    B, S, d = x.shape
    H, hd = rwkv_heads(cfg), RWKV_HEAD_DIM
    x_shift = _token_shift(x, None if state is None else state["x_prev"])

    def lerp(i):
        return x + (x_shift - x) * p["mu"][i]

    r = (lerp(0) @ p["wr"]).reshape(B, S, H, hd)
    k = (lerp(1) @ p["wk"]).reshape(B, S, H, hd)
    v = (lerp(2) @ p["wv"]).reshape(B, S, H, hd)
    w_raw = (lerp(3) @ p["ww"]).float()
    g = lerp(4) @ p["wg"]
    # decay in (0, 1), data-dependent (the Finch contribution)
    w = torch.exp(-torch.exp(w_raw + p["w_bias"])).reshape(B, S, H, hd)
    out, s_new = kops.wkv6(r, k, v, w.to(r.dtype), p["u"],
                           state=None if state is None else state["S"])
    # per-head group norm: an RMS norm over each head's channels
    of = out.float()
    of = of * torch.rsqrt(of.square().mean(dim=-1, keepdim=True) + 1e-6)
    out = (of.reshape(B, S, d) * p["ln_scale"]).to(x.dtype)
    out = out * F.silu(g.float()).to(x.dtype)
    return out @ p["wo"], {"S": s_new, "x_prev": x[:, -1, :]}


def init_rwkv_channel_mix(cfg: ModelConfig, gen: torch.Generator, device,
                          lead: tuple[int, ...] = ()) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mu": torch.full((*lead, 2, d), 0.5, dtype=cfg.dtype, device=device),
        "wk": dense_init(gen, (*lead, d, ff), cfg.dtype, device, in_axis_size=d),
        "wv": dense_init(gen, (*lead, ff, d), cfg.dtype, device, in_axis_size=ff),
        "wr": dense_init(gen, (*lead, d, d), cfg.dtype, device, in_axis_size=d),
    }


def rwkv_channel_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     x_prev: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> ((B, S, d), the last token (B, d)): squared-ReLU key,
    sigmoid receptance gate; ``x_prev`` is the token before x[:, 0]."""
    x_shift = _token_shift(x, x_prev)
    xk = x + (x_shift - x) * p["mu"][0]
    xr = x + (x_shift - x) * p["mu"][1]
    kk = torch.relu((xk @ p["wk"]).float()).square().to(x.dtype)
    r = torch.sigmoid((xr @ p["wr"]).float())
    return r.to(x.dtype) * (kk @ p["wv"]), x[:, -1, :]


# ----------------------------------------------------------------------
# RG-LRU block (RecurrentGemma): proj-in (x2), conv1d, RG-LRU, gated out.
# ----------------------------------------------------------------------

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


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   x_prev: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv; x: (B, S, W); w: (kw, W); b: (W,); ``x_prev``
    (B, kw - 1, W) the inputs before x[:, 0] (zeros when None).  Returns
    (out, the last kw - 1 inputs: the state for the next call).  The taps
    are shifted multiply-adds summed in f32 in the reference's order."""
    kw = w.shape[0]
    B, S, W = x.shape
    pad = x.new_zeros(B, kw - 1, W) if x_prev is None else x_prev
    xp = torch.cat([pad, x], dim=1)
    out = torch.zeros(B, S, W, dtype=torch.float32, device=x.device)
    for i in range(kw):
        out = out + xp[:, i:i + S].float() * w[i].float()
    new_prev = xp[:, xp.shape[1] - (kw - 1):]
    return (out + b.float()).to(x.dtype), new_prev


def rglru_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                state: Params | None = None) -> tuple[torch.Tensor, Params]:
    """x: (B, S, d) -> ((B, S, d), {"h": the scan state (B, W) f32, "conv":
    the conv state (B, kw - 1, W)}); ``state`` is the same dict carried from
    the tokens before, None for a fresh sequence."""
    gate = F.gelu((x @ p["w_in_gate"]).float(), approximate="tanh").to(x.dtype)
    u, conv_state = _causal_conv1d(x @ p["w_in_x"], p["conv_w"], p["conv_b"],
                                   None if state is None else state["conv"])
    r_gate = (u @ p["w_rgate"]).float()
    i_gate = (u @ p["w_igate"]).float()
    y, h = kops.rglru(u, r_gate.to(u.dtype), i_gate.to(u.dtype), p["lam"],
                      h0=None if state is None else state["h"])
    return (y * gate) @ p["w_out"], {"h": h, "conv": conv_state}
