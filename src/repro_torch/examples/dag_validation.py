"""§V-D of the paper, on the card: predict the iteration time of a real
data-parallel training run from its own measured layer costs through the
DAG model, then compare with the measured wall clock (the Fig. 4 method;
the paper reports 4.6-9.4 % error on Caffe-MPI).

Twin of ``examples/dag_validation.py``.  Where the reference forces 8 host
devices, this runs 2 gloo ranks on one card
(:func:`repro_torch.measure.run.spawn_ranks`): qwen1.5-4b at its published
widths, 2 units, 2 sequences of 1024 tokens a rank.

1. Rank 0 times ``embed``, each unit, ``head`` and ``loss`` with
   :func:`repro_torch.traces.generate.generate_trace` (the units through
   the flash kernels) and the optimizer update; both ranks time one gloo
   ``all_reduce`` of each layer's bytes as float32 (mean of 5, once for
   each distinct size).
2. The DAG model predicts ``caffe-mpi`` (wfbp) and ``cntk`` (comm at end)
   with ``shared_compute=True``, since the ranks share the card's compute,
   and without it (ideal parallel), and Eq. (5) gives ``eq5_wfbp``.
3. ``wfbp`` and ``at_end`` steps of :func:`repro_torch.comm.ddp.
   make_ddp_train_step` are timed.

Prints ``RESULT`` and the reference's keys.  ``--device cpu --smoke``
runs the same at :data:`repro_torch.measure.run.SMOKE_GEOMETRY`.

    python -m repro_torch.examples.dag_validation [--device cpu --smoke] [--steps N]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.measure.run import (BACKEND, SMOKE_GEOMETRY, Geometry, config_for,
                                     spawn_ranks)

ARCH = "qwen1.5-4b"
#: 2 ranks on one card, 2 units, 2 x 1024 tokens a rank.
GEOMETRY = Geometry(num_layers=2, seq_len=1024, batch_per_gpu=2, n_devices=2)
#: Timed steps per policy (the reference's).
STEPS = 10


def _mean_s(fn, device: torch.device, n: int = 5) -> float:
    """Mean seconds of ``fn()`` over ``n`` calls after one warm-up call."""
    from repro_torch.measure.harness import _sync

    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / n


def timed_layers(cfg, params, labels):
    """The reference's per-layer split: embed, one layer per unit, head,
    and the loss (a dummy one-element parameter makes it differentiable)."""
    from repro_torch.models import blocks as B
    from repro_torch.models import transformer as T
    from repro_torch.traces.generate import TimedLayer

    def unit_apply(p, x):
        for i, kind in enumerate(cfg.layer_pattern):
            x, _ = B.apply_block(cfg, kind, p[f"b{i}"], x)
        return x

    def xent(p, logits):
        logp = torch.log_softmax(logits.float(), -1)
        picked = torch.gather(logp, -1, labels[..., None])
        return -picked.mean() + 0.0 * p.sum()

    return ([TimedLayer("embed", lambda p, t: p[t], params["embedding"])]
            + [TimedLayer(f"layer{u}", unit_apply, T.unit_slice(params["units"], u))
               for u in range(cfg.num_units)]
            + [TimedLayer("head", lambda p, x: torch.einsum("bsd,dv->bsv", x, p),
                          params["lm_head"]),
               TimedLayer("loss", xent, torch.zeros((1,), device=labels.device))])


def validate(cfg, device: torch.device, g: Geometry, steps: int) -> dict:
    """Runs in every rank of the default process group; rank 0's numbers
    come back on rank 0 (``RESULT``, the per-layer costs, and the kernel
    launches summed over the ranks)."""
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.comm.ddp import make_ddp_train_step
    from repro_torch.comm.sync import Comm
    from repro_torch.core.analytical import eq5_wfbp
    from repro_torch.core.dag import IterationCosts, build_ssgd_dag
    from repro_torch.core.policies import CAFFE_MPI, CNTK
    from repro_torch.core.simulator import simulate
    from repro_torch.measure.calibrate import cluster_name
    from repro_torch.measure.harness import _sync, make_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim.sgd import sgd
    from repro_torch.traces.generate import generate_trace

    rank, world = dist.get_rank(), dist.get_world_size()
    kernels.reset_launches()
    tokens, labels = make_batch(cfg, g.batch_per_gpu * world, g.seq_len)
    shard = slice(rank * g.batch_per_gpu, (rank + 1) * g.batch_per_gpu)
    tokens, labels = tokens[shard].to(device), labels[shard].to(device)
    opt = sgd(lr=1e-2, momentum=0.9)

    # --- 1. per-layer costs on one rank (the paper's per-layer cuDNN
    # times from Caffe) ----------------------------------------------------
    shared = [None]
    if rank == 0:
        params = T.init_lm(cfg, seed=0, device=device)
        trace = generate_trace(timed_layers(cfg, params, labels), tokens, cfg.name,
                               cluster=cluster_name(device.type, BACKEND, 1),
                               n_iterations=2, repeats=3)
        st0 = opt.init(params)
        g0 = T.map_leaves(lambda _, p: torch.ones_like(p), params)
        t_u = _mean_s(lambda: opt.update(g0, st0, params), device)
        shared = [(trace.mean_iteration(), t_u)]
        del params, st0, g0
        if device.type == "cuda":
            torch.cuda.empty_cache()
    dist.broadcast_object_list(shared, src=0)
    mean, t_u = shared[0]

    # comm per layer: one mean all-reduce of that many bytes as float32,
    # timed once for each distinct size (embed and head, the units, match)
    def time_allreduce(nbytes: float) -> float:
        buf = torch.ones(max(int(nbytes) // 4, 1), dtype=torch.float32, device=device)

        def run():
            dist.all_reduce(buf)
            buf.div_(world)

        t = _mean_s(run, device)
        del buf
        return t

    comm_s = {b: time_allreduce(b) for b in sorted({r.size_bytes for r in mean}) if b}
    costs = IterationCosts(
        t_f=[r.forward_us * 1e-6 for r in mean],
        t_b=[r.backward_us * 1e-6 for r in mean],
        t_c=[comm_s.get(r.size_bytes, 0.0) for r in mean],
        t_io=0.0, t_h2d=0.0, t_u=t_u)

    # --- 2. DAG prediction ---------------------------------------------
    # The ranks share one card, so the DAG models worker compute on a
    # shared channel; the ideal-parallel prediction is reported beside it.
    pred = {}
    for pol in (CAFFE_MPI, CNTK):
        graph = build_ssgd_dag(costs, world, pol, n_iterations=5, shared_compute=True)
        pred[pol.name] = simulate(graph).steady_iteration_time()
        ideal = build_ssgd_dag(costs, world, pol, n_iterations=5)
        pred[pol.name + "_ideal_parallel"] = simulate(ideal).steady_iteration_time()
    pred["eq5"] = eq5_wfbp(costs)

    # --- 3. measured wall clock of the real DDP step ----------------------
    comm = Comm()
    batch = {"tokens": tokens, "labels": labels}
    measured = {}
    for polname in ("wfbp", "at_end"):
        params = T.init_lm(cfg, seed=0, device=device)
        st = opt.init(params)
        step = make_ddp_train_step(cfg, opt, comm, sync_policy=polname)
        params, st, m = step(params, st, batch)          # warm-up
        _sync(device)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(steps):
            params, st, m = step(params, st, batch)
        _sync(device)
        measured[polname] = (time.perf_counter() - t0) / steps
        del params, st, m
        if device.type == "cuda":
            torch.cuda.empty_cache()
    shared = [measured]
    dist.broadcast_object_list(shared, src=0)
    measured = shared[0]

    counts = kernels.all_launches()
    launches = torch.tensor(list(counts.values()), dtype=torch.int64)
    dist.all_reduce(launches)

    err = abs(pred["caffe-mpi"] - measured["wfbp"]) / measured["wfbp"] * 100
    result = {
        "predicted_wfbp_s": pred["caffe-mpi"],
        "predicted_cntk_s": pred["cntk"],
        "predicted_wfbp_ideal_parallel_s": pred["caffe-mpi_ideal_parallel"],
        "eq5_ideal_s": pred["eq5"],
        "measured_wfbp_s": measured["wfbp"],
        "measured_at_end_s": measured["at_end"],
        "prediction_error_pct": err,
        "paper_reported_error_pct": "4.6-9.4 (Caffe-MPI, Fig. 4)",
        "note": f"{world} gloo ranks share one {device.type} device, so the DAG "
                "models worker compute on a shared channel",
    }
    return {
        "result": result,
        "layers": [{"name": r.name, "forward_us": r.forward_us, "backward_us": r.backward_us,
                    "comm_s": c, "size_bytes": r.size_bytes}
                   for r, c in zip(mean, costs.t_c)],
        "t_update_s": t_u,
        "kernel_launches": dict(zip(counts, (int(x) for x in launches))),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }


def _validate_rank(rank: int, dev: torch.device, out_file: str, geometry: Geometry,
                   steps: int) -> None:
    doc = validate(config_for(ARCH, geometry), dev, geometry, steps)
    if rank == 0:
        Path(out_file).write_text(json.dumps(doc))


def run_validation(geometry: Geometry = GEOMETRY, steps: int = STEPS,
                   device: str | None = None) -> dict:
    """Spawn ``geometry.n_devices`` ranks, run the validation and return
    rank 0's document (``result`` holds the ``RESULT`` keys).  ``device``
    defaults to CUDA (raises without a GPU)."""
    with tempfile.TemporaryDirectory() as tmp:
        out_file = os.path.join(tmp, "result.json")
        spawn_ranks(_validate_rank, geometry.n_devices, device, out_file, geometry, steps)
        return json.loads(Path(out_file).read_text())


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="repro_torch.examples.dag_validation",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="default cuda; cpu must be asked for")
    p.add_argument("--smoke", action="store_true",
                   help="the reference's tiny CI geometry (measure.run.SMOKE_GEOMETRY)")
    p.add_argument("--steps", type=int, default=STEPS, help=f"timed steps a policy "
                   f"(default {STEPS})")
    args = p.parse_args(argv)
    geometry = dataclasses.replace(SMOKE_GEOMETRY, n_devices=2) if args.smoke else GEOMETRY
    doc = run_validation(geometry, args.steps, args.device)
    print("per-layer costs (rank 0):")
    for r in doc["layers"]:
        print(f"  {r['name']:8s} fwd {r['forward_us'] / 1e3:9.4f} ms  bwd "
              f"{r['backward_us'] / 1e3:9.4f} ms  all-reduce {r['comm_s'] * 1e3:9.3f} ms  "
              f"{r['size_bytes'] / 1e6:9.3f} MB")
    print(f"t_update {doc['t_update_s'] * 1e3:.4f} ms; kernel launches "
          f"{doc['kernel_launches']}")
    print("RESULT " + json.dumps(doc["result"], indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
