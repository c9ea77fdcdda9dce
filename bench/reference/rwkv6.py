"""RWKV-6 "Finch" as the program builds it, float32.

Per layer, pre-norm residual with layer norms: the time mix, then the
channel mix.  Time mix: each of r, k, v, w, g reads ``x + (x_prev - x) *
mu[i]`` (x_prev the token before, zero at the start); the decay is
data-dependent, ``w_t = exp(-exp(x_w ww + w_bias))``; the wkv scan over
heads of ``HEAD`` channels keeps a (key, value) state per head,

    S_t = diag(w_t) S_{t-1} + k_t v_t^T,    o_t = r_t (S_{t-1} + diag(u) k_t v_t^T),

then each head's output is RMS-normed (eps 1e-6), scaled by ``ln_scale``,
gated by silu(g) and projected by ``wo``.  Channel mix: ``sigmoid(x_r wr) *
(relu(x_k wk)^2 wv)`` with its own two token-shift weights.  A final layer
norm and an untied head give the logits.  The departures from the published
model are the program's: static token-shift weights (no data-dependent
lerp), a full-width decay projection (no low-rank one), no layer norm after
the embedding.

The scan is computed exactly in chunks of ``CHUNK`` steps (:func:`wkv`) with
every decay factor a product over a span of steps, exp of a sum of
log-decays that is never positive, so no factor overflows at any decay; the
sums are taken in float64, so a difference of two never cancels."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.common import cross_entropy_sum, layer_norm, pick

HEAD = 64
CHUNK = 16
LN_EPS = 1e-5


def layout(c: dict) -> list[tuple]:
    d, ff, V, L = c["d_model"], c["d_ff"], c["vocab_size"], c["num_layers"]
    H = d // HEAD
    bf, f32 = c["dtype"], "float32"
    rows = [(("embedding",), (V, d), bf, 0.0, d ** -0.5),
            (("final_norm", "bias"), (d,), f32, 0.0, 0.0),
            (("final_norm", "scale"), (d,), f32, 1.0, 0.0),
            (("lm_head",), (d, V), bf, 0.0, d ** -0.5)]
    unit = [(("channel_mix", "mu"), (L, 2, d), bf, 0.5, 0.1),
            (("channel_mix", "wk"), (L, d, ff), bf, 0.0, d ** -0.5),
            (("channel_mix", "wr"), (L, d, d), bf, 0.0, d ** -0.5),
            (("channel_mix", "wv"), (L, ff, d), bf, 0.0, ff ** -0.5),
            (("norm1", "bias"), (L, d), f32, 0.0, 0.0),
            (("norm1", "scale"), (L, d), f32, 1.0, 0.0),
            (("norm2", "bias"), (L, d), f32, 0.0, 0.0),
            (("norm2", "scale"), (L, d), f32, 1.0, 0.0),
            (("time_mix", "ln_scale"), (L, d), f32, 1.0, 0.0),
            (("time_mix", "mu"), (L, 5, d), bf, 0.5, 0.1),
            (("time_mix", "u"), (L, H, HEAD), f32, 0.0, H ** -0.5),
            (("time_mix", "w_bias"), (L, d), f32, -6.0, 0.5)]
    unit += [(("time_mix", w), (L, d, d), bf, 0.0, d ** -0.5)
             for w in ("wg", "wk", "wo", "wr", "wv", "ww")]
    return rows + [(("units", "b0") + path, *rest) for path, *rest in unit]


def wkv(r, k, v, logw, u):
    """r, k, v, logw (S, H, hd), u (H, hd) -> o (S, H, hd), in chunks of
    ``CHUNK`` steps: inside a chunk every (step t, earlier step s) pair's
    decay exp(sum of logw over s < tau < t), the chunk-start state carried
    from chunk to chunk."""
    S, H, hd = r.shape
    pad = -S % CHUNK
    r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, logw))
    n = (S + pad) // CHUNK
    r, k, v, logw = (t.reshape(n, CHUNK, H, hd).permute(2, 0, 1, 3) for t in (r, k, v, logw))
    incl = logw.double().cumsum(2)               # sum of logw up to and with t
    excl = incl - logw.double()                  # ... up to t - 1
    before = torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=r.device).tril(-1)
    span = (excl[:, :, :, None, :] - incl[:, :, None, :, :]).to(r.dtype).masked_fill(
        ~before[:, :, None], float("-inf"))      # (H, n, t, s, hd), <= 0 where s < t
    att = (r[:, :, :, None, :] * k[:, :, None, :, :] * span.exp()).sum(-1)
    o = att @ v + (r * u[:, None, None, :] * k).sum(-1, keepdim=True) * v
    to_end = (incl[:, :, -1:, :] - incl).to(r.dtype).exp()  # decay from step s to the end
    local = (k * to_end).transpose(-1, -2) @ v   # (H, n, hd, hd)
    decay = incl[:, :, -1, :].to(r.dtype).exp()  # (H, n, hd)
    state = torch.zeros(H, hd, hd, dtype=r.dtype, device=r.device)
    starts = []
    for i in range(n):
        starts.append(state)
        state = decay[:, i, :, None] * state + local[:, i]
    o = o + (r * excl.to(r.dtype).exp()) @ torch.stack(starts, 1)
    return o.permute(1, 2, 0, 3).reshape(n * CHUNK, H, hd)[:S]


def _shift(x):
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def layer(c: dict, p: dict, x, mm):
    S, d = x.shape
    H = d // HEAD
    h = layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"], LN_EPS)
    t = p["time_mix"]
    prev = _shift(h)
    mix = [h + (prev - h) * t["mu"][i] for i in range(5)]
    r, k, v = (mm(mix[i], t[w]).view(S, H, HEAD) for i, w in enumerate(("wr", "wk", "wv")))
    logw = -torch.exp(mm(mix[3], t["ww"]) + t["w_bias"]).view(S, H, HEAD)
    o = wkv(r, k, v, logw, t["u"])
    o = o * torch.rsqrt(o.square().mean(-1, keepdim=True) + 1e-6)
    o = o.reshape(S, d) * t["ln_scale"] * F.silu(mm(mix[4], t["wg"]))
    x = x + mm(o, t["wo"])
    h = layer_norm(x, p["norm2"]["scale"], p["norm2"]["bias"], LN_EPS)
    cm = p["channel_mix"]
    prev = _shift(h)
    xk, xr = h + (prev - h) * cm["mu"][0], h + (prev - h) * cm["mu"][1]
    return x + torch.sigmoid(mm(xr, cm["wr"])) * mm(torch.relu(mm(xk, cm["wk"])).square(),
                                                     cm["wv"])


def row_loss(c: dict, params: dict, tokens, labels, mm):
    x = params["embedding"][tokens]
    for u in range(c["num_layers"]):
        x = checkpoint(layer, c, pick(params["units"]["b0"], u), x, mm, use_reentrant=False)
    fn = params["final_norm"]
    x = layer_norm(x, fn["scale"], fn["bias"], LN_EPS)
    return cross_entropy_sum(x, params["lm_head"], labels, mm)
