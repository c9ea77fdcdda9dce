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
4 decode steps with the same shards, the cache this rank's slice by the
rules (sequence-sharded over the ``model`` group where they say so), the
logits of a vocabulary split over ``model`` gathered whole
(``serve_<name>.rank<r>.npz``: its rows, their logits and decoded logits).
A ``runner`` job is :func:`repro_torch.launch.sharded_step.compare_steps`
at reduced widths.  Rank r writes ``rank<r>.json``.

:func:`run_against_reference` runs the reference's script and the ranks
side by side.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.comm.sharded import ShardedHook, shard_params, unshard
from repro_torch.configs import get_config
from repro_torch.launch import sharded_step as SS
from repro_torch.launch import steps
from repro_torch.launch.dryrun import _seq_axes
from repro_torch.launch.mesh import mesh_groups
from repro_torch.measure.run import spawn_ranks
from repro_torch.models import encdec as ED
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as T

SIZES = {"data": 2, "model": 2}
DECODE_TOKENS = 4


def _flat(tree, prefix: str = "") -> dict:
    return {prefix + "/".join(map(str, p)): t.detach().cpu().numpy() for p, t in T.leaf_order(tree)}


def _whole_vocab(hook: ShardedHook, cfg, logits: torch.Tensor) -> torch.Tensor:
    """Logits of every token of the vocabulary, gathered over ``model``
    where this rank holds a block of it."""
    if logits.shape[-1] == cfg.vocab_size:
        return logits
    return hook.tp.comm.all_gather(logits, logits.dim() - 1)


def _serve(rank: int, dev, cfg, params, batch, out: Path, name: str, mode: str) -> None:
    mesh = mesh_groups(SIZES, rank)
    sc = shd.ShardingConfig(tuple(SIZES), mode)
    specs = shd.param_specs(params, sc, sizes=SIZES)
    shards = shard_params(params, specs, SIZES, mesh.coords)
    B, S = batch["tokens"].shape
    axes = SS.batch_axes(cfg, B, S, SIZES, mode)
    rows = SS.local_rows(B, mesh.axes_size(axes), mesh.index(axes))
    local = {k: v[rows].to(dev) for k, v in batch.items()}
    hook = ShardedHook(specs, mesh, axes, tensor_axis=sc.tensor_axis)
    logits = _whole_vocab(hook, cfg, steps.make_prefill_step(cfg, sharded=hook)(shards, local))
    whole = T.init_cache(cfg, B, S, device=dev)
    cspecs = shd.cache_specs(whole, sc, sizes=SIZES)
    data = {"cache": shard_params(whole, cspecs, SIZES, mesh.coords)}
    seq = _seq_axes(cspecs, SIZES)
    if cfg.arch_type == "audio":
        with torch.no_grad():
            data["encoder_states"] = ED.encode(cfg, shards["encoder"], local["frames"],
                                               param_hook=hook, tp=hook.tp)
    serve = steps.make_serve_step(cfg, sharded=hook,
                                  seq_axis=hook.comm.on(mesh.group(seq)) if seq else None)
    decoded = [_whole_vocab(hook, cfg, serve(shards, {**data, "token": local["tokens"][:, t],
                                                      "pos": t})[0])
               for t in range(DECODE_TOKENS)]
    np.savez(out / f"serve_{name}.rank{rank}.npz", rows=rows.numpy(),
             prefill=logits.numpy(), decode=torch.stack(decoded).numpy())


def _case(rank: int, dev, case: dict, out: Path) -> dict:
    cfg = get_config(case["arch"]).reduced(**case["reduced"])
    key = case.get("key", case["arch"])
    with open(out / f"params_{key}.pkl", "rb") as f:
        params = T.from_reference(pickle.load(f), dev)
    with np.load(out / f"batch_{key}.npz") as z:
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
               case["name"], case["mode"])
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


def run_against_reference(tmp: Path, cases: list[dict], batches: dict, extra: list[dict],
                          world: int = 4) -> list[list[dict]]:
    """The reference (``tests/_sharded_reference.py``) in its own process on
    ``world`` forced host devices, the ``world`` port ranks beside it once
    it has written the parameters: every case of ``cases`` (their batches,
    by the cases' ``key`` or arch, in ``batches``) and then every job of
    ``extra`` in one spawn.
    Returns each job's ``world`` rank records, in order."""
    root = Path(__file__).resolve().parents[1]
    (tmp / "cases.json").write_text(json.dumps(cases))
    for arch, batch in batches.items():
        np.savez(tmp / f"batch_{arch}.npz", **batch)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={world}",
               PYTHONPATH=os.pathsep.join([str(root / "src"),
                                           *filter(None, [os.environ.get("PYTHONPATH")])]))
    with open(tmp / "ref.log", "w") as log:
        ref = subprocess.Popen([sys.executable, str(root / "tests" / "_sharded_reference.py"),
                                str(tmp)], env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            spawn_ranks(run_rank, world, "cpu", [*cases, *extra], str(tmp))
        finally:
            rc = ref.wait(timeout=600)
    if rc != 0:
        raise RuntimeError((tmp / "ref.log").read_text()[-4000:])
    results = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]
    return [[results[r][i] for r in range(world)] for i in range(len(cases) + len(extra))]
