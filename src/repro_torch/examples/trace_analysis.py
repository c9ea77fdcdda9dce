"""Simulation study on the paper's published trace (§VI), twin of
``examples/trace_analysis.py``: load the bundled Table VI AlexNet/K80
iteration, replay it through the DAG model under every policy, and
quantify how much communication each overlap strategy hides.  Then close
the loop the other way: measure a *live* torch train step into the same
trace format (``repro_torch.measure``) and run it through the same
predictor as a ``torch:`` workload, beside the paper's trace.

    python -m repro_torch.examples.trace_analysis [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

from repro_torch.core import analytical as A
from repro_torch.core.dag import build_ssgd_dag
from repro_torch.core.hardware import CLUSTERS
from repro_torch.core.policies import ALL_POLICIES, CAFFE_MPI
from repro_torch.core.predictor import predict_workload
from repro_torch.core.simulator import simulate
from repro_torch.traces.bundled import ALEXNET_K80, TOTAL_GRAD_BYTES


def bundled_study() -> None:
    """The first half: Table VI's trace through every policy."""
    costs = ALEXNET_K80.to_iteration_costs()
    print(f"trace: {ALEXNET_K80.network} on {ALEXNET_K80.cluster} "
          f"({costs.num_layers} layers, "
          f"{TOTAL_GRAD_BYTES / 1e6:.0f} MB gradients)")
    print(f"  t_io={costs.t_io:.2f}s  fwd={sum(costs.t_f):.2f}s  "
          f"bwd={sum(costs.t_b):.2f}s  comm={sum(costs.t_c):.2f}s")
    tc_no = A.non_overlapped_comm(costs.t_b, costs.t_c)
    print(f"  Eq.5 non-overlappable comm t_c^no = {tc_no:.3f}s "
          f"({tc_no / sum(costs.t_c) * 100:.0f}% of total comm)\n")

    # effective bandwidth/latency implied by the trace itself (layer comm
    # times in Caffe traces include queueing, so bucket fusion is
    # re-derived from bytes at the trace's own effective bandwidth)
    total_bytes = sum(b for b in costs.grad_bytes if b)
    bw_eff = total_bytes / sum(costs.t_c)
    alpha = min(t for t, b in zip(costs.t_c, costs.grad_bytes) if b)

    def comm_scale(nbytes, _naive):
        return nbytes / bw_eff + alpha

    serial = A.eq2_naive_ssgd(costs)
    print(f"{'policy':45s}{'iter (s)':>10s}{'vs naive':>10s}"
          f"{'comm hidden':>12s}")
    for name, pol in ALL_POLICIES.items():
        g = build_ssgd_dag(costs, 2, pol, n_iterations=6,
                           comm_scale=comm_scale)
        t = simulate(g).steady_iteration_time()
        hidden = serial - t
        print(f"{pol.describe():45s}{t:10.3f}{serial / t:10.2f}x"
              f"{hidden:11.3f}s")

    print("\nper-layer comm profile (top 5 by size):")
    recs = sorted(ALEXNET_K80.mean_iteration(), key=lambda r: -r.size_bytes)
    for r in recs[:5]:
        print(f"  {r.name:6s} {r.size_bytes / 1e6:7.1f} MB  "
              f"comm {r.comm_us / 1e3:7.1f} ms")
    print("\nfc6+fc7 carry ~90% of bytes — exactly the layer-wise "
          "imbalance behind the paper's 9.6% bandwidth-utilization "
          "finding; bucketing fuses the small tail.")


def measured_torch_workload(device: str | None = None) -> dict:
    """The measurement loop, in miniature: instrument a live torch train
    step into the paper's trace format (``repro_torch.measure``, one rank),
    then route the measured ``torch:`` workload through
    ``predict_workload`` next to the bundled Table VI trace.  Returns
    workload -> (layers, prediction)."""
    from repro_torch.measure.run import Geometry, run_measurement
    from repro_torch.traces.format import read_trace

    print("\nmeasuring a live torch train step (tiny qwen variant, one "
          "rank)...", flush=True)
    # the reference's tiny variant at d_model 128, not 64: the flash
    # kernels take head dims of 32 and up
    geometry = Geometry(num_layers=2, d_model=128, num_heads=4, d_ff=128, vocab_size=256,
                        seq_len=16, batch_per_gpu=2, n_devices=1, repeats=2, step_iters=2)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        run_measurement("qwen1.5-4b", td, geometry, policies=("at_end",), device=device)
        path = Path(td) / "qwen1.5-4b.trace"
        measured_layers = read_trace(path).num_layers

        cluster = CLUSTERS["v100-nvlink-ib"]
        print(f"\n{'measured workload':26s}{'layers':>7s}"
              f"{'iter (s) @8xV100':>17s}{'speedup':>8s}")
        for wl in (f"torch:{path}", "trace:alexnet-k80"):
            p = predict_workload(wl, cluster, 8, CAFFE_MPI)
            live = wl.startswith("torch:")
            label = "torch:qwen-tiny (live)" if live else wl
            layers = measured_layers if live else ALEXNET_K80.num_layers
            print(f"{label:26s}{layers:7d}{p.iteration_time:17.4f}"
                  f"{p.speedup:8.2f}")
            out["torch:qwen-tiny" if live else wl] = (layers, p)
    print("the measured torch trace sweeps through the same predictor, "
          "clusters and collectives as the paper's published trace — "
          "comm is re-derived from its gradient bytes.")
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="repro_torch.examples.trace_analysis",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="default cuda; cpu must be asked for")
    args = p.parse_args(argv)
    bundled_study()
    measured_torch_workload(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
