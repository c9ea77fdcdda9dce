"""The paper's Figs. 2-3, twin of ``examples/framework_comparison.py``:
weak scaling of the Caffe-MPI / CNTK / MXNet / TensorFlow policies on both
clusters, all three CNNs, plus the beyond-paper bucketed policy, in one
call to the port's scenario-sweep engine (:func:`repro_torch.core.sweep.
sweep`, ``backend="torch"``: the batched kernel's float64 twin on the
device).

    PYTHONPATH=src python -m repro_torch.examples.framework_comparison [--device cpu]

The grid is the reference's: 3 CNNs x 2 clusters x 1-16 workers x 5
policies, 150 scenarios.  It prints the same Fig. 2 (1-4 GPUs on one node)
and Fig. 3 (1-4 nodes of 4 GPUs) tables and closing findings.  Runs on
CUDA unless ``--device cpu`` is given, and raises without a GPU.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core.scenarios import ScenarioGrid
from repro_torch.core.sweep import sweep
from repro_torch.device import resolve_device

POLICIES = ("caffe-mpi", "cntk", "mxnet", "tensorflow", "bucketed-25mb")
WORKLOADS = ("alexnet", "googlenet", "resnet50")
CLUSTERS = ("k80-pcie-10gbe", "v100-nvlink-ib")


def grid() -> ScenarioGrid:
    """One sweep covers both figures: every (workload, cluster, policy,
    size) cell below is one row of the tidy table."""
    return ScenarioGrid(workloads=WORKLOADS, clusters=CLUSTERS,
                        worker_counts=(1, 2, 4, 8, 16), policies=POLICIES)


def table(result, cluster, workload, gpu_counts):
    print(f"\n--- {workload} on {cluster} "
          f"(samples/s; speedup vs 1 GPU) ---")
    header = f"{'framework':14s}" + "".join(f"{f'x{n}':>16s}"
                                            for n in gpu_counts)
    print(header)
    for pol in POLICIES:
        cells = []
        for n in gpu_counts:
            [r] = result.filter(workload=workload, cluster=cluster,
                                policy=pol, n_workers=n)
            cells.append(f"{r['samples_per_sec']:8.0f} ({r['speedup']:4.1f})")
        print(f"{pol:14s}" + "".join(f"{c:>16s}" for c in cells))


def run(device=None):
    """The sweep on ``device`` and the printed figures; returns the result."""
    result = sweep(grid(), backend="torch", device=resolve_device(device))
    print(f"swept {len(result)} scenarios in {result.elapsed_s:.2f}s "
          f"({result.n_analytical} analytical, {result.n_timeline} "
          f"bucket-timeline, {result.n_simulated} event-driven)")

    print("\nFig. 2 reproduction: single node, 1-4 GPUs")
    for cluster in CLUSTERS:
        for wl in WORKLOADS:
            table(result, cluster, wl, (1, 2, 4))

    print("\nFig. 3 reproduction: 1-4 nodes x 4 GPUs")
    for cluster in CLUSTERS:
        for wl in WORKLOADS:
            table(result, cluster, wl, (4, 8, 16))

    print("\nPaper findings to look for:")
    print(" * K80 cluster scales near-linearly (comm hides behind bwd)")
    print(" * V100 cluster collapses on ResNet (comm-bound; t_c > t_b)")
    print(" * CNTK (no WFBP) always trails the overlapped frameworks")
    print(" * bucketed-25mb (beyond paper) recovers latency-bound losses")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default cuda; cpu must be asked for")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
