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

**Tensor parallelism** (``tp``, :mod:`repro_torch.comm.tensor_parallel`),
in the rules' layout.  RWKV6 time mix: ``wr`` / ``wk`` / ``ww`` / ``wg``
split their output (this rank's heads), ``wv`` and ``wo`` their input
(row-parallel): v is the sum over ``model`` of this rank's input slice's
product, of which the rank keeps its heads (a reduce-scatter), and the
output is all-reduced; ``u`` holds this rank's heads, so wkv6 runs on H /
m heads; the whole ``w_bias`` and ``ln_scale`` are sliced to the rank's
channels.  The token shift and ``mu`` stay replicated: the five
interpolated inputs go through one
:func:`~repro_torch.comm.tensor_parallel.copy_to_model`.  Channel mix:
``wk`` / ``wv`` a column / row pair whose sum the rank keeps its
channels of, ``wr`` column-parallel, their product gathered whole.
Griffin: ``w_in_x`` / ``w_in_gate`` column-parallel, the conv and
``lam`` on the rank's channels, u gathered whole for the ``w_rgate`` /
``w_igate`` products (which split their output), the RG-LRU on (B, S, W /
m), ``w_out`` row-parallel.  A state carried between calls is this rank's
slice (the wkv state on its heads, the scan and conv states on its
channels).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.comm.tensor_parallel import (TensorParallel, copy_to_model,
                                              gather_from_model, row_parallel)
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
                  state: Params | None = None, tp: TensorParallel | None = None,
                  ) -> tuple[torch.Tensor, Params]:
    """x: (B, S, d) -> ((B, S, d), {"S": the wkv state (B, H, hd, hd) f32,
    "x_prev": the last token (B, d)}); ``state`` is the same dict carried
    from the tokens before, None for a fresh sequence.  ``tp``: tensor
    parallelism (module docstring)."""
    B, S, d = x.shape
    tp = tp if tp is not None and p["wr"].shape[-1] < d else None
    H, hd = rwkv_heads(cfg) // (tp.size if tp else 1), RWKV_HEAD_DIM
    x_shift = _token_shift(x, None if state is None else state["x_prev"])

    def lerp(i):
        return x + (x_shift - x) * p["mu"][i]

    w_bias, ln_scale, lerped = p["w_bias"], p["ln_scale"], None
    if tp is not None:
        lerped = copy_to_model(tp, *(lerp(i) for i in range(5)))
        w_bias, ln_scale = (tp.take(t, -1) for t in copy_to_model(tp, w_bias, ln_scale))

    def mixed(i):       # the i-th interpolated input
        return lerp(i) if lerped is None else lerped[i]

    r = (mixed(0) @ p["wr"]).reshape(B, S, H, hd)
    k = (mixed(1) @ p["wk"]).reshape(B, S, H, hd)
    if tp is None:
        v = mixed(2) @ p["wv"]
    else:      # row-parallel: this rank's heads of the sum over its input slices
        v = row_parallel(tp, tp.take(mixed(2), -1), p["wv"], scatter_dim=-1)
    v = v.reshape(B, S, H, hd)
    w_raw = (mixed(3) @ p["ww"]).float()
    g = mixed(4) @ p["wg"]
    # decay in (0, 1), data-dependent (the Finch contribution)
    w = torch.exp(-torch.exp(w_raw + w_bias)).reshape(B, S, H, hd)
    out, s_new = kops.wkv6(r, k, v, w.to(r.dtype), p["u"],
                           state=None if state is None else state["S"])
    # per-head group norm: an RMS norm over each head's channels
    of = out.float()
    of = of * torch.rsqrt(of.square().mean(dim=-1, keepdim=True) + 1e-6)
    out = (of.reshape(B, S, H * hd) * ln_scale).to(x.dtype)
    out = out * F.silu(g.float()).to(x.dtype)
    return row_parallel(tp, out, p["wo"]), {"S": s_new, "x_prev": x[:, -1, :]}


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
                     x_prev: torch.Tensor | None = None, tp: TensorParallel | None = None,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> ((B, S, d), the last token (B, d)): squared-ReLU key,
    sigmoid receptance gate; ``x_prev`` is the token before x[:, 0].
    ``tp``: tensor parallelism (module docstring)."""
    tp = tp if tp is not None and p["wk"].shape[-1] < cfg.d_ff else None
    x_shift = _token_shift(x, x_prev)
    xk = x + (x_shift - x) * p["mu"][0]
    xr = x + (x_shift - x) * p["mu"][1]
    if tp is not None:
        xk, xr = copy_to_model(tp, xk, xr)
    kk = torch.relu((xk @ p["wk"]).float()).square().to(x.dtype)
    r = torch.sigmoid((xr @ p["wr"]).float())
    if tp is None:
        return r.to(x.dtype) * (kk @ p["wv"]), x[:, -1, :]
    kv = row_parallel(tp, kk, p["wv"], scatter_dim=-1)     # this rank's channels of the sum
    return gather_from_model(tp, r.to(x.dtype) * kv, -1), x[:, -1, :]


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
                state: Params | None = None, tp: TensorParallel | None = None,
                ) -> tuple[torch.Tensor, Params]:
    """x: (B, S, d) -> ((B, S, d), {"h": the scan state (B, W) f32, "conv":
    the conv state (B, kw - 1, W)}); ``state`` is the same dict carried from
    the tokens before, None for a fresh sequence.  ``tp``: tensor
    parallelism (module docstring)."""
    tp = tp if tp is not None and p["w_in_x"].shape[-1] < cfg.rnn_size else None
    x = copy_to_model(tp, x)
    gate = F.gelu((x @ p["w_in_gate"]).float(), approximate="tanh").to(x.dtype)
    u, conv_state = _causal_conv1d(x @ p["w_in_x"], p["conv_w"], p["conv_b"],
                                   None if state is None else state["conv"])
    u_all = gather_from_model(tp, u, -1, partial_grad=True)
    r_gate = (u_all @ p["w_rgate"]).float()
    i_gate = (u_all @ p["w_igate"]).float()
    y, h = kops.rglru(u, r_gate.to(u.dtype), i_gate.to(u.dtype), p["lam"],
                      h0=None if state is None else state["h"])
    return row_parallel(tp, y * gate, p["w_out"]), {"h": h, "conv": conv_state}
