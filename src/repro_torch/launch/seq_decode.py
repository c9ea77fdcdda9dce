"""The sequence-sharded decode on N ranks, held against the one-rank
decode on the same cache (:func:`run`; ``chip_smoke.py``'s "sequence-sharded
decode" phase).

For each job (an arch at its published widths and depth, ``seq_len`` and
``positions``), each of N gloo ranks (:func:`repro_torch.measure.run.spawn_ranks`)
builds the same parameters (seed 0) and the same decode cache of ``seq_len``
tokens at batch 1, filled from a seeded generator (:func:`fill_cache`), and
takes its slice of every ``G`` and ``L`` cache (:func:`shard_cache`): the
layout the sharding rules give ``long_500k``.  :func:`compare_decodes` then
decodes one token at each position twice: on the whole cache (the one-rank
decode) and on its slice with ``seq_axis`` a
:class:`repro_torch.comm.sync.Comm` over the ranks
(:func:`repro_torch.models.attention.decode_attention_seq_sharded`).  Per
token it records the logits' and the cache's largest difference from the
one-rank decode; each attention layer's combine, run on the one-rank
decode's own inputs, against that layer's one-rank output, sound and with
the other ranks' partials dropped (the control); the host ms of the
sharded and of the one-rank step; and the bytes and calls handed to the
``Comm``.  Every difference is of the one-rank tensor's own scale.  Per
job it records the port's kernel launches of the sharded decodes alone.
Rank r writes ``rank<r>.json`` into the output directory.
"""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import kernels
from repro_torch.comm.sync import Comm
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.attention import decode_attention_seq_sharded


def _is_kv(path: tuple) -> bool:
    return path[-1] in ("k", "v")


def fill_cache(cache: T.Params, seed: int) -> T.Params:
    """Every leaf of ``cache`` drawn from N(0, 1) in its own dtype, in
    ``leaf_order``, from one generator seeded with ``seed`` on the cache's
    device: the same values in every process."""
    dev = next(t for _, t in T.leaf_order(cache)).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for _, t in T.leaf_order(cache):
        t.copy_(torch.randn(t.shape, generator=gen, device=dev, dtype=t.dtype))
    return cache


def shard_cache(cache: T.Params, rank: int, world: int) -> T.Params:
    """Rank ``rank``'s copy of ``cache``: slots [r·S/N, (r+1)·S/N) of every
    ``k`` / ``v`` leaf's sequence axis (dim -3), the other leaves whole."""
    def piece(path, t):
        if not _is_kv(path):
            return t.clone()
        S = t.shape[-3]
        if S % world:
            raise ValueError(f"{'/'.join(map(str, path))}: {S} slots do not split {world} ways")
        n = S // world
        return t.narrow(-3, rank * n, n).clone()

    return T.map_leaves(piece, cache)


def scaled_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the scale max |want|."""
    want = want.float()
    scale = max(float(want.abs().max()), 1e-6)
    return float((got.float() - want).abs().max()) / scale


class _DropPartials(Comm):
    """The control: a combine that keeps only this rank's partials.  The
    MAX of m still spans the group; the SUMs of o and l are not reduced."""

    def all_reduce(self, t, async_op=False, op=dist.ReduceOp.SUM):
        if op == dist.ReduceOp.MAX:
            return super().all_reduce(t, async_op, op)
        return None


@contextlib.contextmanager
def _tap_local_attention(calls: list):
    """Record (q, k_new, v_new, cache, pos, window) and the output of every
    one-rank attention layer (``attention._decode_local``) while open."""
    local = A._decode_local

    def tapped(q, k_new, v_new, cache, pos, window):
        out = local(q, k_new, v_new, cache, pos, window)
        calls.append(((q, k_new, v_new, cache, pos, window), out))
        return out

    A._decode_local = tapped
    try:
        yield calls
    finally:
        A._decode_local = local


def _combine_err(calls: list, rank: int, world: int, comm: Comm) -> tuple[float, str]:
    """The largest difference, of each layer's own scale, between the
    one-rank layer outputs in ``calls`` and :func:`decode_attention_seq_sharded`
    through ``comm`` on the same inputs and this rank's slice of the same
    cache (a view: the owning rank rewrites the slot with the value the
    one-rank decode wrote), and the layer where it is."""
    worst, where = 0.0, ""
    for i, ((q, k_new, v_new, cache, pos, window), want) in enumerate(calls):
        n = cache["k"].shape[-3] // world
        piece = {name: cache[name].narrow(-3, rank * n, n) for name in ("k", "v")}
        got = decode_attention_seq_sharded(q, k_new, v_new, piece, pos, comm, window=window)
        err = scaled_diff(got, want)
        if err >= worst:
            worst, where = err, f"layer {i}{' (ring)' if window else ''}"
    return worst, where


def compare_decodes(rank: int, dev: torch.device, cfg, seq_len: int, positions: list[int],
                    seed: int = 1) -> dict:
    """The one-rank and the sharded decode of ``cfg`` at ``positions`` on a
    cache of ``seq_len`` tokens filled from ``seed`` (tokens from the same
    seed); returns this rank's record (see the module docstring)."""
    world = torch.distributed.get_world_size()
    comm = Comm()
    params = T.init_lm(cfg, seed=0, device=dev)
    full = fill_cache(T.init_cache(cfg, 1, seq_len, device=dev), seed)
    local = shard_cache(full, rank, world)
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (len(positions), 1), generator=gen)
    steps, launches = [], {}

    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, (time.perf_counter() - t0) * 1e3

    for pos, token in zip(positions, tokens.to(dev)):
        with _tap_local_attention([]) as calls:
            (want, _), one_ms = timed(lambda: T.decode_step(cfg, params, full, token, pos))
        attn_err, attn_where = _combine_err(calls, rank, world, Comm())
        control_err, _ = _combine_err(calls, rank, world, _DropPartials())
        del calls
        comm.reset()
        kernels.reset_launches()
        (got, _), ms = timed(lambda: T.decode_step(cfg, params, local, token, pos,
                                                   seq_axis=comm))
        for name, n in kernels.all_launches().items():
            launches[name] = launches.get(name, 0) + n
        ref_local = shard_cache(full, rank, world)
        cache_err = max(scaled_diff(T.get_path(local, p), t)
                        for p, t in T.leaf_order(ref_local))
        steps.append({"pos": pos, "logits_err": scaled_diff(got, want),
                      "cache_err": cache_err, "attn_err": attn_err, "attn_where": attn_where,
                      "control_err": control_err, "ms": ms, "one_rank_ms": one_ms,
                      "comm_bytes": comm.bytes, "comm_calls": comm.calls})
    return {"num_layers": cfg.num_layers, "dtype": str(cfg.dtype).removeprefix("torch."),
            "seq_len": seq_len, "world": world, "rank": rank, "steps": steps,
            "launches": {k: n for k, n in launches.items() if n}}


def run_rank(rank: int, dev: torch.device, jobs: list[dict], out_dir: str) -> None:
    """:func:`compare_decodes` for every job of ``jobs`` (``arch``,
    ``seq_len``, ``positions``, ``seed`` (default 1)) on this rank; writes
    ``rank<r>.json`` (a list, one entry a job)."""
    from repro_torch.configs import get_config

    results = [{"arch": job["arch"],
                **compare_decodes(rank, dev, get_config(job["arch"]), job["seq_len"],
                                  job["positions"], job.get("seed", 1))} for job in jobs]
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(results, indent=2))


def run(jobs: list[dict], world: int, device, out_dir: str | Path) -> list[list[dict]]:
    """Spawn ``world`` ranks running ``jobs`` on ``device`` (None: CUDA,
    which raises without a GPU), writing into ``out_dir``; returns each
    rank's results."""
    from repro_torch.measure.run import spawn_ranks

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    spawn_ranks(run_rank, world, device, jobs, str(out_dir))
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]
