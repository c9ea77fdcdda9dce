"""The rank jobs of ``tests/test_torch_sharded.py``, in a module of their
own so that the spawned ranks can import them.

Each rank of the ``{data: 2, model: 2}`` mesh waits for the reference's
parameters (``params.done``, :mod:`_sharded_reference`), then for each
case of ``cases.json`` runs :func:`repro_torch.launch.sharded_step.
sharded_train` from them on the case's batch, and again with the division
by the world size skipped (the control).  It writes ``shards_<name>.rank<r>.npz``
(its slice of every parameter before the step, keyed by path) and rank 0
also ``port_<name>.npz`` (the gathered parameters and momentum, and the
control's momentum, keyed ``params/<path>``, ``mom/<path>``,
``control/<path>``).  A case with ``serve`` also runs the prefill step and
4 decode steps with the same shards (``serve_<name>.rank<r>.npz``: its
rows, their logits and decoded logits).  A ``runner`` job is
:func:`repro_torch.launch.sharded_step.compare_steps` at reduced widths.
Rank r writes ``rank<r>.json``.
"""
import dataclasses
import json
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.comm.sharded import ShardedHook, shard_params, unshard
from repro_torch.configs import get_config
from repro_torch.launch import sharded_step as SS
from repro_torch.launch import steps
from repro_torch.launch.mesh import mesh_groups
from repro_torch.models import encdec as ED
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as T

SIZES = {"data": 2, "model": 2}
DECODE_TOKENS = 4


def _flat(tree, prefix: str = "") -> dict:
    return {prefix + "/".join(map(str, p)): t.detach().cpu().numpy() for p, t in T.leaf_order(tree)}


def _serve(rank: int, dev, cfg, params, batch, out: Path, name: str) -> None:
    mesh = mesh_groups(SIZES, rank)
    specs = shd.param_specs(params, shd.ShardingConfig(tuple(SIZES), "zero3"), sizes=SIZES)
    shards = shard_params(params, specs, SIZES, mesh.coords)
    axes = SS.batch_axes(cfg, *batch["tokens"].shape, SIZES, "zero3")
    rows = SS.local_rows(batch["tokens"].shape[0], mesh.axes_size(axes), mesh.index(axes))
    local = {k: v[rows].to(dev) for k, v in batch.items()}
    hook = ShardedHook(specs, mesh, axes)
    logits = steps.make_prefill_step(cfg, sharded=hook)(shards, local)
    cache = T.init_cache(cfg, len(rows), batch["tokens"].shape[1], device=dev)
    data = {"cache": cache}
    if cfg.arch_type == "audio":
        with torch.no_grad():
            data["encoder_states"] = ED.encode(cfg, shards["encoder"], local["frames"],
                                               param_hook=hook)
    serve = steps.make_serve_step(cfg, sharded=hook)
    decoded = [serve(shards, {**data, "token": local["tokens"][:, t], "pos": t})[0]
               for t in range(DECODE_TOKENS)]
    np.savez(out / f"serve_{name}.rank{rank}.npz", rows=rows.numpy(),
             prefill=logits.numpy(), decode=torch.stack(decoded).numpy())


def _case(rank: int, dev, case: dict, out: Path) -> dict:
    cfg = get_config(case["arch"]).reduced(**case["reduced"])
    with open(out / f"params_{case['arch']}.pkl", "rb") as f:
        params = T.from_reference(pickle.load(f), dev)
    with np.load(out / f"batch_{case['arch']}.npz") as z:
        batch = {k: torch.from_numpy(z[k]) for k in z.files}
    kw = {"accum_steps": case["accum_steps"], "remat": case["remat"]}
    run = SS.sharded_train(rank, dev, cfg, params, batch, SIZES, case["mode"], **kw)
    np.savez(out / f"shards_{case['name']}.rank{rank}.npz",
             **_flat(shard_params(params, run["specs"], SIZES, run["mesh"].coords)))
    gathered = {**_flat(unshard(run["shards"], run["specs"], run["mesh"]), "params/"),
                **_flat(unshard(run["state"]["mom"], run["specs"], run["mesh"]), "mom/")}
    control = SS.sharded_train(rank, dev, cfg, params, batch, SIZES, case["mode"], divide=False,
                               **kw)
    gathered.update(_flat(unshard(control["state"]["mom"], control["specs"], control["mesh"]),
                          "control/"))
    if rank == 0:
        np.savez(out / f"port_{case['name']}.npz", **gathered)
    if case.get("serve"):
        _serve(rank, dev, dataclasses.replace(cfg, **case["serve_over"]), params, batch, out,
               case["name"])
    return {"name": case["name"], "rank": rank, "coords": run["mesh"].coords,
            **{k: run[k] for k in ("metrics", "bytes_by_op", "count_by_op")}}


def run_rank(rank: int, dev: torch.device, jobs: list[dict], out_dir: str) -> None:
    out = Path(out_dir)
    deadline = time.time() + 600
    while not (out / "params.done").exists():
        if time.time() > deadline:
            raise TimeoutError("the reference wrote no parameters")
        time.sleep(0.2)
    results = []
    for job in jobs:
        if job.get("kind") == "runner":
            results.append({"name": job["name"], **SS.compare_steps(
                rank, dev, SS.job_config(job), job["sizes"], job["mode"], job["global_batch"],
                job["seq_len"], job["accum_steps"], job["remat"])})
        else:
            results.append(_case(rank, dev, job, out))
    (out / f"rank{rank}.json").write_text(json.dumps(results, indent=2))
