"""One real train step with sharded parameters (``zero3`` / ``fsdp2d``) on N
ranks, held against the replicated ``pure_dp`` step and the dry run
(:func:`run`; ``chip_smoke.py``'s "sharded step (zero3)" phase).

For each job (an arch at its published widths, cut to ``num_layers``; a
mesh ``{axis: size}`` of N ranks; a mode; a global batch of
``global_batch`` x ``seq_len`` tokens; ``accum_steps``; ``remat``) each of
N gloo ranks (:func:`repro_torch.measure.run.spawn_ranks`) builds the same
parameters (seed 0) and the same global batch (seed 1), then runs one SGD
step (lr 1e-2, momentum 0.9) from them three times:

* **the mode** (:func:`sharded_train`): this rank's shards
  (:func:`repro_torch.comm.sharded.shard_params` by the rules of
  :mod:`repro_torch.models.sharding`) and its rows of the batch
  (:func:`local_rows`), gathered per unit by a
  :class:`repro_torch.comm.sharded.ShardedHook`; its loss, ``grad_norm``,
  collectives by op, kernel launches (counted from 0) and, on CUDA, its
  peak above what was allocated before its arguments were made;
* **the control**: the same with the division by the world size skipped;
* **pure_dp** (:func:`replicated_train`): the whole parameters on every
  rank, its rows of the batch over the 1-D mesh of N ranks, the gradients
  mean-reduced at the end (:func:`repro_torch.comm.sync.sync_gradients`),
  the MoE aux loss over the whole batch as in the mode.

The mode's and the control's parameters and momentum are gathered back
(:func:`repro_torch.comm.sharded.unshard`) and compared leaf by leaf with
pure_dp's: after one step from zero momentum the momentum is the
synchronized gradient.  Each difference is of the pure_dp leaf's largest
|value|.  Rank r writes ``rank<r>.json``.  :func:`run` then lowers the same
step with :func:`repro_torch.launch.dryrun.lower` (in the parent, which has
no process group) and :func:`check` applies the limits: ``limit(dtype)``
for the leaves, the loss and the norm; the control beyond it; the counts
by op equal to the dry run's; on CUDA rank 0's peak within
``DRYRUN_PEAK_RTOL`` of the dry run's arguments + temporaries.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

from repro_torch import kernels
from repro_torch.comm import sync as S
from repro_torch.comm.sharded import ShardedHook, shard_params, unshard
from repro_torch.configs import get_config
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import mesh_groups
from repro_torch.launch.seq_decode import scaled_diff
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as T
from repro_torch.models.moe import aux_over_batch
from repro_torch.optim.sgd import sgd

#: f32 limit: ``_tol`` of ``tests/test_kernels.py``, of each leaf's scale
F32_LIMIT = 2e-4
#: bf16 limit: the measurement's ``MOMENTUM_RTOL`` in ``chip_smoke.py``
BF16_LIMIT = 1e-2
#: the real step's peak against the dry run's arguments + temporaries
DRYRUN_PEAK_RTOL = 0.10
LR, MOMENTUM = 1e-2, 0.9


def limit(dtype: torch.dtype) -> float:
    return F32_LIMIT if dtype == torch.float32 else BF16_LIMIT


def batch_axes(cfg, global_batch: int, seq_len: int, sizes: dict[str, int],
               mode: str) -> tuple[str, ...]:
    """The mesh axes the rules split a (global_batch, seq_len) batch over."""
    sc = shd.ShardingConfig(mesh_axes=tuple(sizes), mode=mode)
    return shd.entry_axes(shd.resolve_spec((global_batch, seq_len), [["batch"], ()], sc,
                                           sizes)[0])


def local_rows(global_batch: int, n: int, i: int, accum_steps: int = 1) -> torch.Tensor:
    """The rows of a global batch that part ``i`` of ``n`` holds: of each of
    the ``accum_steps`` microbatches (consecutive blocks of rows, as the
    reference's ``reshape(accum_steps, B // accum_steps, ...)``) its i-th
    block, so that a rank's microbatch k is its share of the global
    microbatch k."""
    micro = global_batch // accum_steps
    if global_batch % accum_steps or micro % n:
        raise ValueError(f"{global_batch} rows do not split into {accum_steps} microbatches "
                         f"of {n} parts")
    part = micro // n
    return torch.cat([torch.arange(k * micro + i * part, k * micro + (i + 1) * part)
                      for k in range(accum_steps)])


def make_batch(cfg, global_batch: int, seq_len: int, seed: int = 1) -> dict:
    """``tokens`` and ``labels`` (int32), and ``frames`` (audio) or ``images``
    (vlm) in ``cfg.dtype``, drawn on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    batch = {k: torch.randint(0, cfg.vocab_size, (global_batch, seq_len), generator=gen,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    key = steps_mod.ENCODER_INPUT.get(cfg.arch_type)
    if key:
        n = cfg.encoder_seq if key == "frames" else cfg.num_image_tokens
        batch[key] = torch.randn((global_batch, n, cfg.d_model), generator=gen).to(cfg.dtype)
    return batch


def _take(batch: dict, rows: torch.Tensor, dev) -> dict:
    return {k: v[rows].to(dev) for k, v in batch.items()}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sharded_train(rank: int, dev: torch.device, cfg, params: T.Params, batch: dict,
                  sizes: dict[str, int], mode: str, *, accum_steps: int = 1,
                  remat: bool = True, divide: bool = True) -> dict:
    """One step of ``mode`` from the whole ``params`` (left as they are) on
    this rank's shards and rows of the global ``batch`` (on the CPU).
    Returns ``shards``, ``state``, ``specs``, ``mesh``, ``metrics`` (floats),
    ``bytes_by_op`` / ``count_by_op``, ``launches`` and ``peak`` (bytes
    above what was allocated before the step's arguments were made; None
    off CUDA)."""
    mesh = mesh_groups(sizes, rank)
    specs = shd.param_specs(params, shd.ShardingConfig(mesh_axes=tuple(sizes), mode=mode),
                            sizes=sizes)
    axes = batch_axes(cfg, batch["tokens"].shape[0], batch["tokens"].shape[1], sizes, mode)
    rows = local_rows(batch["tokens"].shape[0], mesh.axes_size(axes), mesh.index(axes),
                      accum_steps)
    _sync(dev)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    shards = shard_params(params, specs, sizes, mesh.coords)
    opt = sgd(lr=LR, momentum=MOMENTUM)
    state = opt.init(shards)
    local = _take(batch, rows, dev)
    hook = ShardedHook(specs, mesh, axes, divide=divide)
    step = steps_mod.make_train_step(cfg, opt, remat=remat, accum_steps=accum_steps,
                                     sharded=hook)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    _, _, metrics = step(shards, state, local)
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base if dev.type == "cuda" else None
    return {"shards": shards, "state": state, "specs": specs, "mesh": mesh,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "bytes_by_op": dict(hook.comm.bytes_by_op),
            "count_by_op": dict(hook.comm.count_by_op),
            "launches": {k: n for k, n in kernels.all_launches().items() if n}, "peak": peak}


def replicated_train(rank: int, dev: torch.device, cfg, params: T.Params, batch: dict,
                     world: int, *, accum_steps: int = 1, remat: bool = True) -> dict:
    """One ``pure_dp`` step on ``world`` ranks from a copy of ``params``
    (whole): this rank's rows over ``dp<world>``, the gradients mean-reduced
    at the end, the MoE aux loss over the whole batch.  Returns ``params``,
    ``state`` and ``metrics``."""
    params = T.map_leaves(lambda _, t: t.clone(), params)
    opt = sgd(lr=LR, momentum=MOMENTUM)
    state = opt.init(params)
    local = _take(batch, local_rows(batch["tokens"].shape[0], world, rank, accum_steps), dev)
    comm = S.Comm()
    step = steps_mod.make_train_step(cfg, opt, remat=remat, accum_steps=accum_steps,
                                     grad_sync=lambda g: S.sync_gradients(g, "at_end", comm))
    with aux_over_batch(S.Comm() if world > 1 else None):
        _, _, metrics = step(params, state, local)
    return {"params": params, "state": state,
            "metrics": {k: float(v) for k, v in metrics.items()}}


def worst_leaf(got: T.Params, want: T.Params) -> tuple[float, str]:
    """The largest :func:`scaled_diff` over the leaves, and its path."""
    worst, where = 0.0, ""
    for path, t in T.leaf_order(want):
        err = scaled_diff(T.get_path(got, path), t)
        if err >= worst:
            worst, where = err, "/".join(map(str, path))
    return worst, where


def compare_steps(rank: int, dev: torch.device, cfg, sizes: dict[str, int], mode: str,
                  global_batch: int, seq_len: int, accum_steps: int = 1,
                  remat: bool = True) -> dict:
    """The mode, the control and pure_dp from seed-0 parameters and a seed-1
    batch; this rank's record (module docstring)."""
    world = mesh_groups(sizes, rank).world
    params = steps_mod.init_params(cfg, seed=0, device=dev)
    batch = make_batch(cfg, global_batch, seq_len)
    run = sharded_train(rank, dev, cfg, params, batch, sizes, mode,
                        accum_steps=accum_steps, remat=remat)
    got = {"params": unshard(run["shards"], run["specs"], run["mesh"]),
           "mom": unshard(run["state"]["mom"], run["specs"], run["mesh"])}
    record = {k: run[k] for k in ("metrics", "bytes_by_op", "count_by_op", "launches", "peak")}
    del run
    control = sharded_train(rank, dev, cfg, params, batch, sizes, mode,
                            accum_steps=accum_steps, remat=remat, divide=False)
    control_mom = unshard(control["state"]["mom"], control["specs"], control["mesh"])
    del control
    ref = replicated_train(rank, dev, cfg, params, batch, world, accum_steps=accum_steps,
                           remat=remat)
    errs = {"params": worst_leaf(got["params"], ref["params"]),
            "mom": worst_leaf(got["mom"], ref["state"]["mom"]),
            "control_mom": worst_leaf(control_mom, ref["state"]["mom"])}
    want = ref["metrics"]
    record.update({
        "rank": rank, "world": world, "num_layers": cfg.num_layers,
        "dtype": str(cfg.dtype).removeprefix("torch."), "pure_dp_metrics": want,
        "norm_err": abs(record["metrics"]["grad_norm"] - want["grad_norm"])
        / want["grad_norm"],
        "bitwise": all(torch.equal(T.get_path(got["mom"], p), t)
                       for p, t in T.leaf_order(ref["state"]["mom"])),
        **{f"{k}_err": v[0] for k, v in errs.items()},
        **{f"{k}_where": v[1] for k, v in errs.items()}})
    return record


def run_rank(rank: int, dev: torch.device, jobs: list[dict], out_dir: str) -> None:
    """:func:`compare_steps` for every job (``arch``, ``num_layers`` or
    ``reduced`` (:func:`job_config`), ``sizes``, ``mode``, ``global_batch``,
    ``seq_len``, ``accum_steps``, ``remat``) on this rank; writes
    ``rank<r>.json`` (a list, one entry a job)."""
    results = [{"arch": job["arch"], **compare_steps(
        rank, dev, job_config(job), job["sizes"], job["mode"], job["global_batch"],
        job["seq_len"], job.get("accum_steps", 1), job.get("remat", True))} for job in jobs]
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(results, indent=2))


def job_config(job: dict):
    """The arch's config at the job's ``num_layers`` of its published widths,
    or at ``reduced()`` widths with the job's ``reduced`` overrides."""
    if "reduced" in job:
        return get_config(job["arch"]).reduced(**job["reduced"])
    return dataclasses.replace(get_config(job["arch"]), num_layers=job["num_layers"]).validate()


def dry_run(job: dict) -> dict:
    """The dry run's record of the job's step (:func:`repro_torch.launch.
    dryrun.lower`, on this torch's :func:`~repro_torch.launch.dryrun.
    lowering_device`)."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.dryrun import lower

    shape = InputShape("sharded_step", job["seq_len"], job["global_batch"], "train")
    return lower(job_config(job), shape, mesh=job["sizes"], mode=job["mode"],
                 remat=job.get("remat", True), accum_steps=job.get("accum_steps", 1))


def check(job: dict, ranks: list[dict], dry: dict, on_cuda: bool) -> list[str]:
    """What is wrong with a job's rank records against its limits and its
    dry run (module docstring); empty when nothing is."""
    lim = limit(job_config(job).dtype)
    bad = []
    # a rank's loss is its rows'; the mean over the world is the whole
    # batch's in both steps (rows held by several ranks average out)
    got, want = (sum(r[key]["total_loss"] for r in ranks) / len(ranks)
                 for key in ("metrics", "pure_dp_metrics"))
    if not abs(got - want) <= lim * abs(want):
        bad.append(f"loss {got!r} against pure_dp's {want!r}")
    for res in ranks:
        r = res["rank"]
        for key in ("params_err", "mom_err", "norm_err"):
            if not res[key] <= lim:
                bad.append(f"rank {r}: {key} {res[key]:.3e} over {lim:.0e}")
        if not res["control_mom_err"] > lim:
            bad.append(f"rank {r}: the control's momentum {res['control_mom_err']:.3e} is "
                       "within the limit")
        col = dry["collectives"]
        if res["bytes_by_op"] != col["bytes_by_op"] or res["count_by_op"] != col["count_by_op"]:
            bad.append(f"rank {r}: collectives {res['count_by_op']} calls "
                       f"{res['bytes_by_op']} B, the dry run {col['count_by_op']} calls "
                       f"{col['bytes_by_op']} B")
    if on_cuda:
        mem = dry["memory"]
        predicted = mem["argument_bytes"] + mem["temp_bytes"]
        if not abs(ranks[0]["peak"] / predicted - 1) <= DRYRUN_PEAK_RTOL:
            bad.append(f"rank 0's peak {ranks[0]['peak']} B against the dry run's "
                       f"{predicted} B")
    return bad


def run(jobs: list[dict], world: int, device, out_dir: str | Path
        ) -> list[tuple[list[dict], dict, list[str]]]:
    """Spawn ``world`` ranks running ``jobs`` on ``device`` (None: CUDA,
    which raises without a GPU), writing into ``out_dir``; then the dry run
    of each job here.  Returns, per job, (the ranks' records, the dry run's
    record, :func:`check`'s findings)."""
    from repro_torch.measure.run import resolve_device, spawn_ranks

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    spawn_ranks(run_rank, world, device, jobs, str(out_dir))
    results = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]
    on_cuda = resolve_device(device).type == "cuda"
    out = []
    for i, job in enumerate(jobs):
        ranks = [results[r][i] for r in range(world)]
        dry = dry_run(job)
        out.append((ranks, dry, check(job, ranks, dry, on_cuda)))
    return out
