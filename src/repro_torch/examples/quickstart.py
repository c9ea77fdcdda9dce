"""Quickstart, twin of ``examples/quickstart.py``: the three layers of the
framework.

1. ANALYZE  — build the paper's S-SGD DAG for a workload + cluster and
              predict scaling under each framework policy.
2. TRAIN    — run real S-SGD steps with a prefetching input pipeline.
3. TRACE    — emit a paper-format layer-wise trace of a small model.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs on CUDA unless ``--device cpu`` is given, and raises without a GPU.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.core.hardware import V100_CLUSTER
from repro_torch.core.policies import CAFFE_MPI, CNTK
from repro_torch.core.predictor import predict_cnn
from repro_torch.data.pipeline import PrefetchLoader, SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import transformer as T
from repro_torch.optim.sgd import sgd
from repro_torch.traces.generate import TimedLayer, generate_trace


def run(device=None, steps: int = 10) -> dict:
    """The three layers on ``device``; returns the predictions, the losses
    and the trace's mean iteration."""
    device = resolve_device(device)
    out: dict = {"device": str(device)}

    print("=== 1. DAG model: ResNet-50 on the V100/InfiniBand cluster ===")
    out["predictions"] = {}
    for pol in (CAFFE_MPI, CNTK):
        p = predict_cnn("resnet50", V100_CLUSTER, 16, pol)
        out["predictions"][pol.name] = p.iteration_time
        print(f"  {pol.describe():60s} iter={p.iteration_time * 1e3:7.1f} ms "
              f"speedup={p.speedup:5.2f}/16")

    print(f"=== 2. real S-SGD training (reduced gemma3, {device.type}) ===")
    cfg = get_config("gemma3-1b").reduced(num_layers=2)
    params = T.init_lm(cfg, seed=0, device=device)
    opt = sgd(lr=3e-3, momentum=0.9)
    state = opt.init(params)
    loader = PrefetchLoader(SyntheticLMDataset(cfg.vocab_size, 64, 8), depth=2, device=device)
    losses = []
    try:
        for i, batch in zip(range(steps), loader):
            loss, _, grads = loss_and_grads(cfg, params, batch["tokens"], batch["labels"])
            params, state = opt.update(grads, state, params)
            losses.append(float(loss))
            if i % 3 == 0:
                print(f"  step {i} loss {losses[-1]:.4f}")
    finally:
        loader.close()
    out["losses"] = losses
    print(f"  pipeline means: t_io={loader.mean_t_io() * 1e3:.2f} ms "
          f"t_h2d={loader.mean_t_h2d() * 1e3:.2f} ms")

    print("=== 3. layer-wise trace (paper Table-VI format) of a 2-layer MLP ===")
    gen = torch.Generator(device=device).manual_seed(0)
    layers = [
        TimedLayer("fc1", lambda p, x: torch.tanh(x @ p),
                   torch.randn(128, 256, generator=gen, device=device) * 0.05),
        TimedLayer("fc2", lambda p, x: x @ p,
                   torch.randn(256, 64, generator=gen, device=device) * 0.05),
    ]
    trace = generate_trace(layers, torch.ones(8, 128, device=device), "mlp-demo",
                           n_iterations=1, repeats=2,
                           comm_time_fn=lambda b: V100_CLUSTER.allreduce_time(b, 16))
    out["trace"] = trace.mean_iteration()
    for rec in out["trace"]:
        print(f"  {rec.layer_id} {rec.name:5s} fwd={rec.forward_us:8.1f}us "
              f"bwd={rec.backward_us:8.1f}us comm={rec.comm_us:6.1f}us "
              f"size={rec.size_bytes:9.0f}B")
    print("done.")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default cuda; cpu must be asked for")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    run(args.device, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
