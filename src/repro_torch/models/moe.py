"""Mixture-of-Experts MLP with grouped einsum dispatch.

Counterpart of :mod:`repro.models.moe` lines 20-106.  Tokens are processed
in groups of ``moe_group_size`` (the last padded with zero tokens); each
group computes an f32 top-k router, builds a (group, expert, capacity)
dispatch / combine pair, and the expert FFNs run as one batched einsum
over the expert axis.  Tokens over an expert's capacity are dropped and
fall through the residual connection.  Shared experts (qwen2-moe) are a
plain gated MLP of width ``shared_expert_d_ff``.  The reference computes
all of it outside any Pallas kernel, so the port's are torch einsums too.

Two choices keep the routing the reference's exactly: the top-k is a
stable descending sort (``jax.lax.top_k`` puts the lower expert first on
a tie, as on the zero padding tokens, whose probabilities are uniform),
and the one-hot tensors are comparisons with an ``arange``, so that the
capacity index ``C`` of a dropped choice gives an all-zero row as
``jax.nn.one_hot`` does (``torch.nn.functional.one_hot`` raises on it).

**A batch split over ranks** (:func:`aux_over_batch`, which the sharded
train step of :mod:`repro_torch.launch.steps` opens): the aux loss's two
means, each expert's routed fraction and mean router probability, are
taken over the whole batch of the ranks that split it, as the reference's
SPMD step takes them over its global batch.  One all-reduce of the 2·E
means a layer, whose backward all-reduces the probabilities' cotangent
(the transpose of a sum over ranks is a sum over ranks).  The groups are
the reference's only where every rank's tokens fill whole groups: it
raises otherwise.  Without it (one rank; the paper's S-SGD of
:mod:`repro_torch.comm.sync`, as the reference's ``comm.ddp``) each rank's
aux is its own batch's.

**Expert and tensor parallelism** (``tp``, :mod:`repro_torch.comm.
tensor_parallel`).  The router (d, E) and the aux loss stay replicated on
the ``model`` ranks, on the whole tokens.  Where E divides ``model`` the
rules split the experts (``wi``, ``wg``, ``wo`` on E): a rank runs its E / m
experts on the tokens dispatched to them (the tokens are whole on every
``model`` rank, so nothing is exchanged) and its partial combine is
all-reduced.  Elsewhere (qwen2-moe-a2.7b's 60 and grok-1-314b's 8 experts
on 16) ``wi`` / ``wg`` split their hidden dim and ``wo`` stays whole: a
rank takes its rows of ``wo``, and its partial output is all-reduced in
the activations' dtype (:func:`~repro_torch.comm.tensor_parallel.
row_parallel`'s rule).  The combine weights, and a whole ``wo``, go through
:func:`~repro_torch.comm.tensor_parallel.copy_to_model`, since a rank uses
them in part; the shared experts are a column / row pair.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from repro_torch.comm.tensor_parallel import (TensorParallel, copy_to_model,
                                              reduce_from_model, row_parallel)
from repro_torch.models.common import ModelConfig, Params, dense_init


def init_moe(cfg: ModelConfig, gen: torch.Generator | None, device,
             lead: tuple[int, ...] = ()) -> Params:
    """``router`` (d, E) in float32, the experts' ``wi``, ``wg`` (E, d, ff)
    and ``wo`` (E, ff, d) in ``cfg.dtype``, and the ``shared`` MLP when
    ``shared_expert_d_ff`` is set; every leaf with the leading axes
    ``lead``."""
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p: Params = {
        "router": dense_init(gen, (*lead, d, E), torch.float32, device, in_axis_size=d),
        "wi": dense_init(gen, (*lead, E, d, ff), cfg.dtype, device, in_axis_size=d),
        "wg": dense_init(gen, (*lead, E, d, ff), cfg.dtype, device, in_axis_size=d),
        "wo": dense_init(gen, (*lead, E, ff, d), cfg.dtype, device, in_axis_size=ff),
    }
    if cfg.shared_expert_d_ff:
        sf = cfg.shared_expert_d_ff
        p["shared"] = {
            "wi": dense_init(gen, (*lead, d, sf), cfg.dtype, device, in_axis_size=d),
            "wg": dense_init(gen, (*lead, d, sf), cfg.dtype, device, in_axis_size=d),
            "wo": dense_init(gen, (*lead, sf, d), cfg.dtype, device, in_axis_size=sf),
        }
    return p


#: a :class:`repro_torch.comm.sync.Comm` over the ranks that split the
#: batch, while :func:`aux_over_batch` is open
_BATCH_COMM: contextvars.ContextVar = contextvars.ContextVar("moe_batch_comm", default=None)


@contextlib.contextmanager
def aux_over_batch(comm):
    """Take the aux loss's means over the batch of ``comm``'s group (module
    docstring) while open; ``comm`` None leaves each rank's own."""
    token = _BATCH_COMM.set(comm)
    try:
        yield
    finally:
        _BATCH_COMM.reset(token)


class _MeanOverRanks(torch.autograd.Function):
    """The mean of ``t`` over ``comm``'s group; its backward is the mean of
    the cotangent over the same group."""

    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        out = t.detach().clone()
        comm.all_reduce(out)
        return out / comm.world

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.comm.all_reduce(g)
        return g / ctx.comm.world, None


def _capacity(cfg: ModelConfig, group: int) -> int:
    c = int(group * cfg.experts_per_token * cfg.capacity_factor
            / max(cfg.num_experts, 1))
    return max(c, 1)


def route(cfg: ModelConfig, router: torch.Tensor, xg: torch.Tensor):
    """The router of the groups ``xg`` (G, g, d): ``(probs (G, g, E) f32,
    gate values (G, g, k) f32 renormalised over the k choices, onehot (G,
    g, k, E) int32 of the k chosen experts in order, pos (G, g, k) each
    choice's slot in its expert, keep = pos < C)``."""
    E, k = cfg.num_experts, cfg.experts_per_token
    G, g, _ = xg.shape
    logits = torch.einsum("Ggd,dE->GgE", xg.float(), router)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, top_e = vals[..., :k], idx[..., :k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    # each (token, choice)'s slot in its expert's capacity, counted
    # token-major then choice, in int32 as the reference's
    onehot = (top_e[..., None] == torch.arange(E, device=xg.device)).int()
    flat = onehot.reshape(G, g * k, E)
    pos = ((torch.cumsum(flat, dim=1, dtype=torch.int32) - flat) * flat).sum(
        dim=-1, dtype=torch.int32).reshape(G, g, k)
    return probs, gate_vals, onehot, pos, pos < _capacity(cfg, g)


def moe_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor,
            tp: TensorParallel | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss): the Switch load-balancing loss, E
    times the sum over experts of the fraction of tokens routed to each
    (not differentiated) by its mean router probability.  ``tp``: expert
    and tensor parallelism on ``model`` (module docstring)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    comm = _BATCH_COMM.get()
    g = min(cfg.moe_group_size, T * (comm.world if comm is not None else 1))
    if comm is not None and T % g:
        raise ValueError(f"{T} tokens a rank do not fill groups of {g}: the groups would "
                         "differ from those of the whole batch")
    expert_split = tp is not None and p["wi"].shape[-3] < E
    ff_split = tp is not None and not expert_split and p["wi"].shape[-1] < cfg.moe_d_ff
    tp_e = tp if expert_split or ff_split else None
    tp_s = tp if "shared" in p and p["shared"]["wi"].shape[-1] < cfg.shared_expert_d_ff \
        else None
    if tp_e is not None and tp_s is not None:     # one all-reduce of the cotangent
        x_e = x_s = copy_to_model(tp, x)
    else:
        x_e, x_s = copy_to_model(tp_e, x), copy_to_model(tp_s, x)
    xg = _groups(x, g)
    G = xg.shape[0]
    C = _capacity(cfg, g)

    # the router and the aux loss on the whole tokens, replicated over model
    probs, gate_vals, onehot, pos, keep = route(cfg, p["router"], xg)
    chosen = onehot[..., 0, :] if k == 1 else onehot.amax(dim=2)      # (G,g,E)
    frac = (chosen.sum(dim=1) / g).mean(dim=0)
    mean_prob = probs.mean(dim=(0, 1))
    if comm is not None:
        frac, mean_prob = _MeanOverRanks.apply(
            torch.cat([frac.to(mean_prob.dtype), mean_prob]), comm).split(E)
    aux = E * (frac * mean_prob).sum()

    dt = xg.dtype
    slot = torch.where(keep, pos, C)          # C, a dropped choice: an all-zero row
    pos_oh = (slot[..., None] == torch.arange(C, device=x.device)).to(dt)  # (G,g,k,C)
    kept = onehot.to(dt) * keep[..., None]
    if expert_split:                          # this rank's experts
        kept = tp_e.take(kept, -1)
    gate_vals = copy_to_model(tp_e, gate_vals)
    disp = torch.einsum("GgkE,Ggkc->GgEc", kept, pos_oh)
    comb = torch.einsum("GgkE,Ggkc->GgEc", gate_vals.to(dt)[..., None] * kept, pos_oh)

    wo = p["wo"]
    if ff_split:                              # this rank's rows of the whole wo
        wo = tp_e.take(copy_to_model(tp_e, wo), -2)
    xg_e = xg if x_e is x else _groups(x_e, g)
    expert_in = torch.einsum("GgEc,Ggd->EGcd", disp, xg_e)              # (E,G,C,d)
    h = torch.einsum("EGcd,Edf->EGcf", expert_in, p["wi"])
    gates = torch.einsum("EGcd,Edf->EGcf", expert_in, p["wg"])
    h = h * F.silu(gates.float()).to(h.dtype)
    expert_out = torch.einsum("EGcf,Efd->EGcd", h, wo)
    out = torch.einsum("GgEc,EGcd->Ggd", comb, expert_out).reshape(-1, d)[:T]
    out = reduce_from_model(tp_e, out).reshape(B, S, d)   # a partial sum over model

    if "shared" in p:
        sp = p["shared"]
        hs = x_s @ sp["wi"]
        gs = x_s @ sp["wg"]
        hs = hs * F.silu(gs.float()).to(hs.dtype)
        out = out + row_parallel(tp_s, hs, sp["wo"])
    return out, aux


def _groups(x: torch.Tensor, g: int) -> torch.Tensor:
    """The tokens of x (B, S, d) in groups of g, (G, g, d), the last padded
    with zero tokens."""
    d = x.shape[-1]
    tokens = x.reshape(-1, d)
    pad = (-tokens.shape[0]) % g
    if pad:
        tokens = torch.cat([tokens, tokens.new_zeros(pad, d)])
    return tokens.reshape(-1, g, d)
