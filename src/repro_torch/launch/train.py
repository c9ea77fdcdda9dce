"""Training launcher.

Runs real steps with the full substrate engaged: the prefetching data
pipeline, the gradient-sync policy, the optimizer and checkpointing.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --steps 20 --policy wfbp --data-parallel 1 [--device cpu]

Counterpart of :mod:`repro.launch.train`: the same flags and summary, plus
``--device`` (CUDA unless ``--device cpu`` is given; raises without a
GPU).  ``--data-parallel 0`` means every local device: the CUDA device
count on the card, 1 on the CPU.  At a world of 1, or with ``--policy
single``, each step is the port's ``loss_fn``, ``torch.autograd.grad`` and
the optimizer's update, in this process.  At a larger world the ranks are
spawned (:func:`repro_torch.measure.run.spawn_ranks`: gloo, which also
puts two ranks on one card) and step through
:func:`repro_torch.comm.ddp.make_ddp_train_step` under ``--policy``, each
on its shard of the global batch of ``--batch`` rows; rank 0 reports.
``samples_per_s`` is that global batch over the mean step time (the
reference multiplies it by the world once more).  As in the reference, an
``audio`` or ``vlm`` arch (whisper-tiny, llama-3.2-vision-90b) trains as
its dense ``G`` backbone alone (:func:`repro_torch.launch.steps.
dense_backbone`).

``--trace-out PATH`` (one process) records the run's spans
(:mod:`repro_torch.tracing`) and writes the paper's layer-wise trace of its
steps after the first two to ``PATH`` (:mod:`repro_torch.traces.recorded`,
:func:`repro_torch.traces.format.write_trace`): the embedding, each unit
and the head with the loss, forward and backward on the device's clock,
each layer's gradient bytes, no communication.  ``python -m
repro.launch.sweep --workloads trace:PATH`` and the port's sweep read it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device

#: steps the trace leaves out, as ``mean_step_s`` does
WARM_STEPS = 2


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", choices=("sgd", "adamw"), default="sgd")
    ap.add_argument("--policy", default="wfbp",
                    choices=("at_end", "wfbp", "bucketed", "single"))
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="DP world size (0 = all local devices)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="pipeline depth; 0 = blocking I/O (naive S-SGD)")
    ap.add_argument("--io-delay", type=float, default=0.0,
                    help="injected per-batch fetch latency (seconds)")
    ap.add_argument("--checkpoint")
    ap.add_argument("--summary-json")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--trace-out",
                    help="write the paper's layer-wise trace of the steps here "
                         "(one process)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default cuda; cpu must be asked for")
    return ap


def train_loop(args, device: torch.device, rank: int = 0, world: int = 1, comm=None):
    """The training loop of one rank (``comm`` None: one process).  Returns
    (the summary, the parameters and the optimizer state at the end)."""
    from repro_torch.checkpoint.ckpt import save_checkpoint
    from repro_torch.data.pipeline import PrefetchLoader, SyntheticLMDataset
    from repro_torch.launch.steps import dense_backbone, init_params, loss_and_grads
    from repro_torch.optim.sgd import adamw, sgd
    from repro_torch.traces.format import write_trace
    from repro_torch.traces.recorded import layer_times, paper_trace

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(num_layers=2)
    cfg = dense_backbone(cfg)
    opt = sgd(args.lr, momentum=0.9) if args.optimizer == "sgd" else adamw(args.lr)
    params = init_params(cfg, seed=0, device=device)
    opt_state = opt.init(params)
    dataset = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch, seed=1,
                                 simulate_io_seconds=args.io_delay)
    loader = PrefetchLoader(dataset, depth=args.prefetch, device=device)

    if comm is None:
        @tracing.spanned("step")
        def step(p, s, batch):
            total, metrics, grads = loss_and_grads(cfg, p, batch["tokens"], batch["labels"])
            p, s = opt.update(grads, s, p)
            return p, s, {"loss": metrics["loss"], "total_loss": total}
    else:
        from repro_torch.comm.ddp import make_ddp_train_step

        if args.batch % world:
            raise ValueError(f"--batch {args.batch} does not split over {world} ranks")
        shard = slice(rank * args.batch // world, (rank + 1) * args.batch // world)
        ddp_step = make_ddp_train_step(cfg, opt, comm, sync_policy=args.policy)

        def step(p, s, batch):
            return ddp_step(p, s, {k: v[shard].long() for k, v in batch.items()})

    losses, step_times = [], []
    layer_steps = []         # each recorded step's layer times, all the trace keeps
    traced = (tracing.record(device, on_step=lambda _, spans: layer_steps.append(
        layer_times(spans))) if args.trace_out else contextlib.nullcontext())
    t_prev = time.perf_counter()
    try:
        with traced as rec:
            for i, batch in zip(range(args.steps), loader):
                params, opt_state, metrics = step(params, opt_state, batch)
                losses.append(float(metrics["loss"]))       # waits for the step
                now = time.perf_counter()
                step_times.append(now - t_prev)
                t_prev = now
                if rank == 0 and (i % args.log_every == 0 or i == args.steps - 1):
                    print(f"step {i:4d} loss {losses[-1]:.4f} "
                          f"({step_times[-1] * 1e3:.1f} ms)", flush=True)
    finally:
        loader.close()

    if rec is not None:
        rec.summary()
        trace = paper_trace(layer_steps[WARM_STEPS:] or layer_steps, params, cfg.name,
                            f"torch-{device.type}-x{world}", batch_per_gpu=args.batch,
                            bytes_per_sample=8.0 * args.seq)
        write_trace(trace, args.trace_out)
        print(f"trace -> {args.trace_out}", flush=True)

    if args.checkpoint and rank == 0:
        save_checkpoint(args.checkpoint, params, opt_state, step=args.steps)
        print(f"checkpoint -> {args.checkpoint}", flush=True)

    warm = step_times[WARM_STEPS:] or step_times
    summary = {
        "arch": cfg.name, "steps": args.steps, "world": world, "policy": args.policy,
        "loss_first": losses[0], "loss_last": losses[-1],
        "mean_step_s": float(np.mean(warm)),
        "t_io_mean": loader.mean_t_io(), "t_h2d_mean": loader.mean_t_h2d(),
        "samples_per_s": args.batch / float(np.mean(warm)),
    }
    return summary, params, opt_state


def _train_rank(rank: int, device: torch.device, args, out_path: str) -> None:
    import torch.distributed as dist

    from repro_torch.comm.sync import Comm

    summary = train_loop(args, device, rank, dist.get_world_size(), Comm())[0]
    if rank == 0:
        Path(out_path).write_text(json.dumps(summary))


def run(args) -> dict:
    device = resolve_device(args.device)
    n_dp = args.data_parallel or (torch.cuda.device_count() if device.type == "cuda" else 1)
    if args.policy == "single" or n_dp == 1:
        summary = train_loop(args, device)[0]
    elif args.trace_out:
        raise SystemExit("--trace-out records one process: give --data-parallel 1 "
                         "or --policy single")
    else:
        from repro_torch.measure.run import spawn_ranks

        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "summary.json"
            spawn_ranks(_train_rank, n_dp, str(device), args, str(out))
            summary = json.loads(out.read_text())
    if args.summary_json:
        Path(args.summary_json).write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    return summary


def main(argv=None):
    run(build_argparser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
