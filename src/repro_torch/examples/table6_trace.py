"""Paper Table VI / §VI on the card: the layer-wise trace dataset.

Twin of ``benchmarks/bench_table6_trace.py``.  Derives the aggregate
quantities of the bundled AlexNet/K80 iteration (total gradient bytes
~= 244 MB = 61M f32 parameters; forward/backward/comm totals),
round-trips it through the trace format, then times fresh traces of the
paper's two CNNs (Table IV) layer by layer on the device, in full float32
(TF32 off), with the Comm. column priced by the K80 cluster's 16-GPU
all-reduce as in the reference:

* AlexNet at 224 x 224, batch 1024 (11 timed layers; fc6 is 6400 x 4096,
  since pool5 is 5 x 5 at 224: 203.4 MB of gradients, not Table VI's
  244 MB);
* ResNet-50 (3, 4, 6, 3) at 224 x 224, batch 32 (19 timed layers).

Each trace is written, read back and resolved through ``trace:<file>``.
With ``--device cpu`` AlexNet runs at 99 x 99 (pool5 2 x 2) and ResNet at
64 x 64 with one block a stage and width 8, both at batch 2.

    python -m repro_torch.examples.table6_trace [--device cpu] [--out-dir DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.core.hardware import K80_CLUSTER
from repro_torch.core.workloads import resolve_workload
from repro_torch.device import resolve_device
from repro_torch.models import cnn
from repro_torch.traces.bundled import ALEXNET_K80, TOTAL_GRAD_BYTES
from repro_torch.traces.format import read_trace, write_trace
from repro_torch.traces.generate import generate_trace


def reduced_networks(device: torch.device) -> dict:
    """name -> (layers builder, batch) at CPU sizes: AlexNet at 99 x 99,
    ResNet at 64 x 64 with one block a stage and width 8, batch 2."""
    return {
        "alexnet": (lambda: cnn.alexnet_timed_layers(0, input_hw=99, device=device), 2),
        "resnet50": (lambda: cnn.resnet_timed_layers(
            0, input_hw=64, depth_per_stage=(1, 1, 1, 1), width=8, device=device), 2),
    }


def networks(device: torch.device) -> dict:
    """name -> (layers builder, batch): Table IV's sizes on the card,
    :func:`reduced_networks` on the CPU."""
    if device.type == "cpu":
        return reduced_networks(device)
    return {
        "alexnet": (lambda: cnn.alexnet_timed_layers(0, input_hw=224, device=device), 1024),
        "resnet50": (lambda: cnn.resnet_timed_layers(0, input_hw=224, device=device), 32),
    }


def row(name: str, us: float, extra: str) -> None:
    print(f"{name:34s} {us:12.1f} us  {extra}", flush=True)


def bundled() -> dict:
    """Table VI's totals and its round trip through the format."""
    t0 = time.perf_counter()
    costs = ALEXNET_K80.to_iteration_costs()
    us = (time.perf_counter() - t0) * 1e6
    totals = {"grad_MB": TOTAL_GRAD_BYTES / 1e6, "t_io_s": costs.t_io,
              "fwd_s": sum(costs.t_f), "bwd_s": sum(costs.t_b), "comm_s": sum(costs.t_c)}
    row("table6/bundled/totals", us, ";".join(f"{k}={v:.2f}" if k != "grad_MB"
                                               else f"{k}={v:.1f}" for k, v in totals.items()))
    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "alexnet_k80.trace"
        t0 = time.perf_counter()
        write_trace(ALEXNET_K80, p)
        us = (time.perf_counter() - t0) * 1e6
        ok = read_trace(p).iterations[0] == ALEXNET_K80.iterations[0]
    row("table6/roundtrip", us, f"identical={ok}")
    return {"grad_bytes": TOTAL_GRAD_BYTES, "totals": totals, "roundtrip_ok": ok}


def fresh_trace(name: str, build, batch: int, device: torch.device, out_dir: Path) -> dict:
    """Time ``name``'s layers at ``batch`` into ``<out_dir>/<name>.trace``,
    read it back and resolve it through ``trace:<file>``."""
    layers, x0 = build()
    x = x0.expand(batch, *x0.shape[1:]).contiguous(memory_format=torch.channels_last)
    t0 = time.perf_counter()
    trace = generate_trace(layers, x, name, cluster=f"torch-{device.type}-f32",
                           comm_time_fn=lambda b: K80_CLUSTER.allreduce_time(b, 16))
    us = (time.perf_counter() - t0) * 1e6
    # the trace records the batch it was timed at
    trace = dataclasses.replace(trace, batch_per_gpu=batch)
    path = out_dir / f"{name}.trace"
    write_trace(trace, path)
    back = read_trace(path)
    if back != trace:
        raise RuntimeError(f"{path} does not read back as written")
    table = resolve_workload(f"trace:{path}")
    if table.num_layers != trace.num_layers:
        raise RuntimeError(f"trace:{path} resolves to {table.num_layers} layers, "
                           f"not {trace.num_layers}")
    mean = trace.mean_iteration()
    doc = {"path": str(path), "batch": batch, "layers": len(mean),
           "fwd_us": sum(r.forward_us for r in mean),
           "bwd_us": sum(r.backward_us for r in mean),
           "grad_bytes": sum(r.size_bytes for r in mean),
           "records": [dataclasses.asdict(r) for r in mean]}
    row(f"table6/generated-{name}", us,
        f"layers={doc['layers']};fwd_us={doc['fwd_us']:.0f};bwd_us={doc['bwd_us']:.0f};"
        f"grad_MB={doc['grad_bytes'] / 1e6:.1f};batch={batch}")
    for r in mean:
        print(f"  {name:9s} {r.layer_id:3d} {r.name:6s} fwd {r.forward_us / 1e3:10.4f} ms  "
              f"bwd {r.backward_us / 1e3:10.4f} ms  comm {r.comm_us / 1e3:9.3f} ms  "
              f"{r.size_bytes / 1e6:8.3f} MB", flush=True)
    del layers, x0, x
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return doc


def run(out_dir: str | Path, device=None) -> dict:
    """Table VI's totals and round trip, then a fresh trace of each network
    into ``out_dir``; returns the numbers printed."""
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    out = bundled()
    out["device"] = str(dev)
    out["generated"] = {name: fresh_trace(name, build, batch, dev, out_dir)
                        for name, (build, batch) in networks(dev).items()}
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="repro_torch.examples.table6_trace",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="default cuda; cpu must be asked for")
    p.add_argument("--out-dir", default=None,
                   help="where the traces go (default: a temporary directory)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        out = run(args.out_dir or tmp, args.device)
    print(json.dumps({k: v for k, v in out.items() if k != "generated"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
