"""One real train step with sharded parameters (``zero3`` / ``fsdp2d`` /
``fsdp``, or ``pure_dp`` with tensor parallelism on a mesh with a ``model``
axis) on N ranks, held against the replicated ``pure_dp`` step on the same
rows and the dry run (:func:`run`; ``chip_smoke.py``'s "sharded step
(zero3)" and "sharded step (fsdp)" phases; :func:`main` runs one job).

For each job (an arch at its published widths, cut to ``num_layers``; a
mesh ``{axis: size}`` of N ranks; a mode; a global batch of
``global_batch`` x ``seq_len`` tokens; ``accum_steps``; ``remat``) each of
N gloo ranks (:func:`repro_torch.measure.run.spawn_ranks`) builds the same
parameters (seed 0) and the same global batch (seed 1), then runs one SGD
step (lr 1e-2, momentum 0.9) from them three times (pure_dp first; each
step from the parameters drawn anew, so that four ranks of published
widths fit one card):

* **the mode** (:func:`sharded_train`): this rank's shards
  (:func:`repro_torch.comm.sharded.shard_params` by the rules of
  :mod:`repro_torch.models.sharding`) and its rows of the batch
  (:func:`local_rows`), gathered per unit by a
  :class:`repro_torch.comm.sharded.ShardedHook`, which carries the
  blocks' tensor parallelism where the mode has it (under ``pure_dp`` its
  gradients are synchronized over the batch axes by ``at_end``); its loss,
  ``grad_norm``,
  collectives by op, kernel launches (counted from 0) and, on CUDA, its
  peak above what was allocated before its arguments were made;
* **the control**: the same with the division by the world size skipped;
* **pure_dp** (:func:`replicated_train`): the whole parameters on every
  rank, its rows of the batch as the mode splits it (``pure_dp`` on
  ``dp<D>`` for the D ranks that split the batch, repeated on the
  others), the gradients mean-reduced over those D at the end
  (:func:`repro_torch.comm.sync.sync_gradients`), the MoE aux loss over
  the whole batch as in the mode.  The same rows summed in the same groups
  as the mode's: a difference is then the mode's own.  In bfloat16 its
  rounding alone is of the order of ``BF16_LIMIT``: ``fsdp2d`` (no
  tensor split) reads 5e-3–7e-3 of a leaf's scale at reduced widths on
  the CPU (:func:`main`), a tensor-parallel step more;
* **the bfloat16 witness** (a job's ``bf16_witness``, a float32 job): every
  step above starts from the same bfloat16-drawn parameters, and then
  pure_dp and the mode run again in bfloat16.  Each one's momentum is
  held to float32 pure_dp's: the mode's distance from it may be at most
  ``WITNESS_RATIO`` times pure_dp's own, so that a fault of the
  tensor-parallel path that shows only in bfloat16 is told from the
  rounding that any bfloat16 step has.  The record's ``bf16`` holds both
  distances, the mode's from bfloat16 pure_dp, and the bfloat16 mode's
  counts and peak, which :func:`check_witness` holds to the bfloat16 dry
  run.

The mode's and the control's parameters and momentum are gathered back a
leaf at a time (:func:`repro_torch.comm.sharded.unshard`) and compared with
pure_dp's (:func:`worst_leaf`): after one step from zero momentum the momentum is the
synchronized gradient.  Each difference is of the pure_dp leaf's largest
|value|.  Rank r writes ``rank<r>.json``.  :func:`run` then lowers the same
step with :func:`repro_torch.launch.dryrun.lower` (in the parent, which has
no process group) and :func:`check` applies the limits: ``limit(dtype)``
for the leaves, the loss and the norm; the control beyond it; the counts
by op equal to the dry run's; on CUDA rank 0's peak within
``DRYRUN_PEAK_RTOL`` of the dry run's arguments + temporaries, the dry run
of the step as gloo runs it (:func:`dry_run`).  Each record's ``seconds``
times its parts.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import torch
import torch.distributed as dist

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
#: the bfloat16 mode's momentum, as a distance from float32 pure_dp's, over
#: bfloat16 pure_dp's own distance from it (worst leaves)
WITNESS_RATIO = 2.0
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
                  remat: bool = True, divide: bool = True, mesh=None) -> dict:
    """One step of ``mode`` from the whole ``params`` (left as they are) on
    this rank's shards and rows of the global ``batch`` (on the CPU).
    Returns ``shards``, ``state``, ``specs``, ``mesh``, ``metrics`` (floats),
    ``bytes_by_op`` / ``count_by_op``, ``launches`` and ``peak`` (bytes
    above what was allocated before the step's arguments were made; None
    off CUDA).  ``mesh``: this rank's :class:`repro_torch.launch.mesh.
    MeshGroups` on ``sizes``, whose process groups are made once (default:
    a new one)."""
    mesh = mesh or mesh_groups(sizes, rank)
    sc = shd.ShardingConfig(mesh_axes=tuple(sizes), mode=mode)
    specs = shd.param_specs(params, sc, sizes=sizes)
    axes = batch_axes(cfg, batch["tokens"].shape[0], batch["tokens"].shape[1], sizes, mode)
    rows = local_rows(batch["tokens"].shape[0], mesh.axes_size(axes), mesh.index(axes),
                      accum_steps)
    _sync(dev)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    shards = shard_params(params, specs, sizes, mesh.coords)
    opt = sgd(lr=LR, momentum=MOMENTUM)
    state = opt.init(shards)
    local = _take(batch, rows, dev)
    hook = ShardedHook(specs, mesh, axes, divide=divide, tensor_axis=sc.tensor_axis,
                       policy="at_end" if mode == "pure_dp" else None)
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
                     mesh, axes: tuple[str, ...], *, accum_steps: int = 1,
                     remat: bool = True) -> dict:
    """One ``pure_dp`` step that updates ``params`` (whole) in place: this
    rank's rows of the batch as the mode splits it (over the mesh axes
    ``axes``), the gradients mean-reduced at the end over the ranks of those
    axes, the MoE aux loss over the whole batch.  That is ``pure_dp`` on
    ``dp<D>`` for the D ranks that split the batch, repeated on the others:
    its gradients sum the same rows in the same groups as the mode's, so
    that a difference between the two is the mode's own.  Returns
    ``params``, ``state`` and ``metrics``."""
    opt = sgd(lr=LR, momentum=MOMENTUM)
    state = opt.init(params)
    n = mesh.axes_size(axes)
    local = _take(batch, local_rows(batch["tokens"].shape[0], n, mesh.index(axes), accum_steps),
                  dev)
    comm = S.Comm(mesh.group(axes)) if n > 1 else None
    step = steps_mod.make_train_step(cfg, opt, remat=remat, accum_steps=accum_steps,
                                     grad_sync=lambda g: S.sync_gradients(g, "at_end", comm))
    with aux_over_batch(comm):
        _, _, metrics = step(params, state, local)
    return {"params": params, "state": state,
            "metrics": {k: float(v) for k, v in metrics.items()}}


def worst_leaf(shards: T.Params, specs: T.Params, mesh, *wants: T.Params | None
               ) -> list[tuple[float, str, bool]] | None:
    """For each tree of ``wants``: the largest :func:`scaled_diff` of the
    whole leaves of ``shards`` against its leaves, that leaf's path, and
    whether every leaf equals its own bit for bit; each leaf gathered
    (:func:`repro_torch.comm.sharded.unshard`) and compared in turn, so that
    no whole tree is held twice.  With ``wants`` None the rank takes part in
    the gathers and compares nothing."""
    found = [[0.0, "", True] for _ in wants]
    for path, t in T.leaf_order(shards):
        got = unshard(t, T.get_path(specs, path), mesh)
        if wants[0] is None:
            continue
        for f, want in zip(found, wants):
            ref = T.get_path(want, path)
            f[2] = f[2] and torch.equal(got, ref)
            err = scaled_diff(got, ref)
            if err >= f[0]:
                f[:2] = err, "/".join(map(str, path))
    return None if wants[0] is None else [tuple(f) for f in found]


def worst_pair(got: T.Params, want: T.Params) -> tuple[float, str]:
    """The largest :func:`scaled_diff` of ``got``'s leaves against
    ``want``'s (two whole trees of one rank), and that leaf's path."""
    return max((scaled_diff(t, T.get_path(want, path)), "/".join(map(str, path)))
               for path, t in T.leaf_order(got))


def compare_steps(rank: int, dev: torch.device, cfg, sizes: dict[str, int], mode: str,
                  global_batch: int, seq_len: int, accum_steps: int = 1,
                  remat: bool = True, bf16_witness: bool = False) -> dict:
    """pure_dp, the mode and the control from seed-0 parameters and a seed-1
    batch; this rank's record (module docstring).  Each step starts from
    the parameters drawn anew (pure_dp updates its own in place).  Ranks
    that hold the same rows (the ``model`` ranks of a ``data`` shard under
    ``fsdp``) would repeat pure_dp's step and the comparisons: the first of
    them runs them and hands the others its findings, so that four ranks of
    published widths fit one card.  ``bf16_witness`` (a float32 ``cfg``):
    every step starts from bfloat16 parameters, and pure_dp and the mode
    then run again in bfloat16 (record ``bf16``, module docstring)."""
    mesh = mesh_groups(sizes, rank)
    world = mesh.world
    batch = make_batch(cfg, global_batch, seq_len)
    axes = batch_axes(cfg, global_batch, seq_len, sizes, mode)
    same_rows = tuple(a for a in sizes if a not in axes)
    first = mesh.index(same_rows) == 0
    for group_axes in (axes, same_rows):    # made by every rank in one order, once
        if mesh.axes_size(group_axes) > 1:
            mesh.group(group_axes)
    if bf16_witness and cfg.dtype != torch.float32:
        raise ValueError("the bfloat16 witness compares with a float32 step")
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)

    def draw(c):    # under the witness, float32 steps start from bfloat16 draws
        if not bf16_witness or c is cfg16:
            return steps_mod.init_params(c, seed=0, device=dev)
        return T.map_leaves(lambda _, t: t.float(),
                            steps_mod.init_params(cfg16, seed=0, device=dev))

    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        _sync(dev)
        seconds[name], t0 = time.perf_counter() - t0, time.perf_counter()

    ref = replicated_train(rank, dev, cfg, draw(cfg), batch, mesh, axes,
                           accum_steps=accum_steps, remat=remat) if first else None
    lap("pure_dp")
    run = sharded_train(rank, dev, cfg, draw(cfg), batch, sizes, mode,
                        accum_steps=accum_steps, remat=remat, mesh=mesh)
    lap("mode")
    record = {k: run[k] for k in ("metrics", "bytes_by_op", "count_by_op", "launches", "peak")}
    ref_mom = ref and ref["state"]["mom"]
    errs = {"params": worst_leaf(run["shards"], run["specs"], run["mesh"],
                                 ref and ref["params"]),
            "mom": worst_leaf(run["state"]["mom"], run["specs"], run["mesh"], ref_mom)}
    want = ref and ref["metrics"]
    del run, ref
    lap("compare")
    control = sharded_train(rank, dev, cfg, draw(cfg), batch, sizes, mode,
                            accum_steps=accum_steps, remat=remat, divide=False, mesh=mesh)
    errs["control_mom"] = worst_leaf(control["state"]["mom"], control["specs"],
                                     control["mesh"], ref_mom)
    del control
    lap("control")
    witness = None
    if bf16_witness:
        batch16 = make_batch(cfg16, global_batch, seq_len)
        pd16 = replicated_train(rank, dev, cfg16, draw(cfg16), batch16, mesh, axes,
                                accum_steps=accum_steps, remat=remat)["state"]["mom"] \
            if first else None
        run16 = sharded_train(rank, dev, cfg16, draw(cfg16), batch16, sizes, mode,
                              accum_steps=accum_steps, remat=remat, mesh=mesh)
        found = worst_leaf(run16["state"]["mom"], run16["specs"], run16["mesh"], ref_mom, pd16)
        witness = {k: run16[k] for k in ("bytes_by_op", "count_by_op", "peak")}
        if first:
            witness.update(zip(("pure_dp_err", "pure_dp_where"), worst_pair(pd16, ref_mom)))
            for key, (err, where, _) in zip(("mode", "mode_vs_pure_dp"), found):
                witness.update({f"{key}_err": err, f"{key}_where": where})
        del pd16, run16
        lap("bf16")
    found = [errs, want, witness]
    if mesh.axes_size(same_rows) > 1:
        dist.broadcast_object_list(found, src=mesh.ranks(same_rows)[0],
                                   group=mesh.group(same_rows))
    errs, want, first_witness = found
    if witness is not None:     # this rank's own counts and peak, the first's distances
        witness = {**first_witness, **witness}
    record.update({
        "rank": rank, "world": world, "num_layers": cfg.num_layers,
        "dtype": str(cfg.dtype).removeprefix("torch."), "pure_dp_metrics": want,
        "norm_err": abs(record["metrics"]["grad_norm"] - want["grad_norm"])
        / want["grad_norm"],
        "bitwise": errs["mom"][0][2], "seconds": seconds,
        **({"bf16": witness} if witness is not None else {}),
        **{f"{k}_err": v[0][0] for k, v in errs.items()},
        **{f"{k}_where": v[0][1] for k, v in errs.items()}})
    return record


def run_rank(rank: int, dev: torch.device, jobs: list[dict], out_dir: str) -> None:
    """:func:`compare_steps` for every job (``arch``, ``num_layers`` or
    ``reduced`` (:func:`job_config`), ``sizes``, ``mode``, ``global_batch``,
    ``seq_len``, ``accum_steps``, ``remat``, ``bf16_witness``) on this rank; writes
    ``rank<r>.json`` (a list, one entry a job)."""
    results = [{"arch": job["arch"], **compare_steps(
        rank, dev, job_config(job), job["sizes"], job["mode"], job["global_batch"],
        job["seq_len"], job.get("accum_steps", 1), job.get("remat", True),
        job.get("bf16_witness", False))} for job in jobs]
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(results, indent=2))


def job_config(job: dict):
    """The arch's config at the job's ``num_layers`` of its published widths,
    or at ``reduced()`` widths with the job's ``reduced`` overrides; in the
    job's ``dtype`` (a ``torch`` attribute name) if it names one."""
    over = {"dtype": getattr(torch, job["dtype"])} if "dtype" in job else {}
    if "reduced" in job:
        return get_config(job["arch"]).reduced(**{**job["reduced"], **over})
    return dataclasses.replace(get_config(job["arch"]), num_layers=job["num_layers"],
                               **over).validate()


def dry_run(job: dict) -> dict:
    """The dry run's record of the job's step as gloo ranks run it
    (:func:`repro_torch.launch.dryrun.lower` with ``gloo``, on this torch's
    :func:`~repro_torch.launch.dryrun.lowering_device`), and under ``bf16``
    that of its bfloat16 step where the job has the witness."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.dryrun import lower

    shape = InputShape("sharded_step", job["seq_len"], job["global_batch"], "train")
    rec = lower(job_config(job), shape, mesh=job["sizes"], mode=job["mode"],
                remat=job.get("remat", True), accum_steps=job.get("accum_steps", 1),
                gloo=True)
    if job.get("bf16_witness"):
        rec["bf16"] = dry_run({**job, "dtype": "bfloat16", "bf16_witness": False})
    return rec


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
    if "bf16" in dry:
        bad += [f"bfloat16: {b}" for b in check_witness(ranks, dry["bf16"], on_cuda)]
    return bad


def check_witness(ranks: list[dict], dry: dict, on_cuda: bool) -> list[str]:
    """What is wrong with the ranks' bfloat16 steps (each record's ``bf16``)
    against ``WITNESS_RATIO`` and their dry run ``dry``."""
    bad = []
    col = dry["collectives"]
    for res in ranks:
        w, r = res["bf16"], res["rank"]
        if not w["mode_err"] <= WITNESS_RATIO * w["pure_dp_err"]:
            bad.append(f"rank {r}: momentum {w['mode_err']:.3e} ({w['mode_where']}) from "
                       f"float32 pure_dp's, over {WITNESS_RATIO} x bfloat16 pure_dp's "
                       f"{w['pure_dp_err']:.3e} ({w['pure_dp_where']})")
        if w["bytes_by_op"] != col["bytes_by_op"] or w["count_by_op"] != col["count_by_op"]:
            bad.append(f"rank {r}: collectives {w['count_by_op']} calls {w['bytes_by_op']} B, "
                       f"the dry run {col['count_by_op']} calls {col['bytes_by_op']} B")
    if on_cuda:
        predicted = dry["memory"]["argument_bytes"] + dry["memory"]["temp_bytes"]
        if not abs(ranks[0]["bf16"]["peak"] / predicted - 1) <= DRYRUN_PEAK_RTOL:
            bad.append(f"rank 0's peak {ranks[0]['bf16']['peak']} B against the dry run's "
                       f"{predicted} B")
    return bad


def run(jobs: list[dict], world: int, device, out_dir: str | Path
        ) -> list[tuple[list[dict], dict, list[str]]]:
    """Spawn ``world`` ranks running ``jobs`` on ``device`` (None: CUDA,
    which raises without a GPU), writing into ``out_dir``, and meanwhile the
    dry run of each job here.  Returns, per job, (the ranks' records, the
    dry run's record, :func:`check`'s findings)."""
    from repro_torch.measure.run import resolve_device, spawn_ranks

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    drys = spawn_ranks(run_rank, world, device, jobs, str(out_dir),
                       meanwhile=lambda: [dry_run(job) for job in jobs])
    results = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]
    on_cuda = resolve_device(device).type == "cuda"
    out = []
    for i, (job, dry) in enumerate(zip(jobs, drys)):
        ranks = [results[r][i] for r in range(world)]
        out.append((ranks, dry, check(job, ranks, dry, on_cuda)))
    return out


def main(argv=None) -> int:
    """One job from the command line: every rank's record and the findings
    of :func:`check`; exit 1 if there are any.

        PYTHONPATH=src python -m repro_torch.launch.sharded_step \\
            --arch rwkv6-1.6b --num-layers 1 --mesh data=2,model=2 --mode fsdp \\
            [--dtype bfloat16] [--global-batch 4] [--seq-len 1024] [--device cpu]
    """
    import argparse
    import math
    import tempfile

    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser(description=main.__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--num-layers", type=int, help="depth at published widths")
    ap.add_argument("--reduced", type=json.loads,
                    help="reduced() widths instead, with these overrides (JSON)")
    ap.add_argument("--mesh", default="data=2,model=2", help="axis=size,...")
    ap.add_argument("--mode", default="fsdp", choices=shd.MODES)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"))
    ap.add_argument("--bf16-witness", action="store_true",
                    help="(float32) then pure_dp and the mode in bfloat16, held to "
                         "WITNESS_RATIO")
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--device", help="cpu; default the card")
    args = ap.parse_args(argv)
    if (args.num_layers is None) == (args.reduced is None):
        ap.error("one of --num-layers and --reduced")
    sizes = {axis: int(n) for axis, n in (kv.split("=") for kv in args.mesh.split(","))}
    job = {"arch": args.arch, "sizes": sizes, "mode": args.mode,
           "global_batch": args.global_batch, "seq_len": args.seq_len,
           **({"num_layers": args.num_layers} if args.reduced is None else
              {"reduced": args.reduced}),
           **({"dtype": args.dtype} if args.dtype else {}),
           **({"bf16_witness": True} if args.bf16_witness else {})}
    with tempfile.TemporaryDirectory() as out:
        [(ranks, dry, bad)] = run([job], math.prod(sizes.values()), args.device, out)
    keys = ("rank", "dtype", "metrics", "pure_dp_metrics", "params_err", "params_where",
            "mom_err", "mom_where", "control_mom_err", "norm_err", "peak", "count_by_op",
            "seconds", "bf16")
    for res in ranks:
        print(json.dumps({k: res[k] for k in keys if k in res}))
    print(json.dumps({"dry_run_collectives": dry["collectives"]["count_by_op"],
                      "findings": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
