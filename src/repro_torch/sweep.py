"""Scenario-sweep CLI of the port: evaluate a grid of S-SGD what-if
scenarios on the card and print the tidy results table (the counterpart
of ``python -m repro.launch.sweep``, batched paths only).

    PYTHONPATH=src python -m repro_torch.sweep                    # CUDA
    PYTHONPATH=src python -m repro_torch.sweep --device cpu
    PYTHONPATH=src python -m repro_torch.sweep --grid frontier --csv /tmp/f.csv
    PYTHONPATH=src python -m repro_torch.sweep \\
        --workloads torch:qwen1.5-4b,trace:alexnet-k80 \\
        --clusters v100-nvlink-ib --workers 2,8,32 \\
        --policies caffe-mpi,bucketed-25mb,priority

Workloads resolve through :mod:`repro_torch.core.workloads`: bare paper
CNN names or ``cnn:<name>``, ``trace:<bundled-name-or-file-path>``,
``llm:<arch>`` (the port's archs) and measured ``torch:<name-or-path>``
traces from ``python -m repro_torch.measure`` (``--list-workloads``).
Axis values are comma-separated; ``--interconnects`` accepts the presets,
scaled what-ifs (``ib-100g@bw2@lat0.25``) and ``default``.  ``--backend
torch`` (the default) evaluates on ``--device`` (CUDA unless ``cpu``; no
GPU is an error), ``--backend numpy`` on the host.  Policies with neither
a closed nor a bucket-timeline form are refused: the port runs no
event-driven simulator.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core.hardware import (COLLECTIVE_ALGORITHMS,
                                       INTERCONNECT_PRESETS)
from repro_torch.core.scenarios import grid_from_spec
from repro_torch.core.sweep import BACKENDS, COLUMNS, sweep
from repro_torch.core.workloads import known_workloads
from repro_torch.device import resolve_device


def _csv_list(text: str) -> list[str]:
    return [t.strip() for t in text.split(",") if t.strip()]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch.sweep",
        description="Batched what-if sweep over the S-SGD DAG model, on the card.")
    p.add_argument("--grid", choices=("default", "mixed", "frontier"),
                   default="default",
                   help="base grid: 'default' (paper CNNs, 540 scenarios), "
                        "'mixed' (cnn:/trace:/llm: providers, 1620) or "
                        "'frontier' (bandwidth x latency x bucket-size x "
                        "priority what-ifs, 51840); other axis flags "
                        "override any of them")
    p.add_argument("--workloads", type=_csv_list, default=None,
                   help="comma-separated workload names: bare CNNs "
                        "(alexnet,googlenet,resnet50), cnn:<name>, "
                        "trace:<bundled-or-path>, llm:<arch>, "
                        "torch:<measured-name-or-path> (see --list-workloads; "
                        "measure with `python -m repro_torch.measure`)")
    p.add_argument("--list-workloads", action="store_true",
                   help="print every registered workload name and exit")
    p.add_argument("--clusters", type=_csv_list, default=None,
                   help="comma-separated cluster names")
    p.add_argument("--workers", type=_csv_list, default=None,
                   help="comma-separated worker counts, e.g. 1,4,16,64")
    p.add_argument("--policies", type=_csv_list, default=None,
                   help="comma-separated policy names (see repro_torch.core.policies)")
    p.add_argument("--collectives", type=_csv_list, default=None,
                   help=f"comma-separated algorithms {COLLECTIVE_ALGORITHMS}")
    p.add_argument("--interconnects", type=_csv_list, default=None,
                   help="comma-separated presets "
                        f"({', '.join(sorted(INTERCONNECT_PRESETS))}) "
                        "and/or 'default'")
    p.add_argument("--het", type=_csv_list, default=None,
                   help="comma-separated heterogeneity profiles: 'none' "
                        "and/or 'het:<slots>' specs, e.g. het:1x0.5+3x1.0")
    p.add_argument("--stragglers", type=_csv_list, default=None,
                   help="comma-separated straggler models: 'none' and/or "
                        "'<dist>:<scale>[x<draws>]' with dist lognormal|exp; "
                        "Monte Carlo tails land in t_mean_s/t_p95_s/t_p99_s")
    p.add_argument("--sync-k", type=_csv_list, default=None,
                   help="comma-separated K-of-N partial-sync thresholds: "
                        "'none'/'0' (full sync) and/or positive K")
    p.add_argument("--faults", type=_csv_list, default=None,
                   help="comma-separated fault models: 'none' and/or "
                        "'fail:<p>[@restart<T>][x<draws>]'")
    p.add_argument("--seed", type=int, default=0,
                   help="seed for the straggler and fault Monte Carlo draws "
                        "(default 0; the same draws on both backends)")
    p.add_argument("--batch-per-gpu", type=int, default=None,
                   help="override the workload's per-GPU batch size")
    p.add_argument("--backend", choices=BACKENDS, default="torch",
                   help="'torch' (default: the two tiers on --device) or "
                        "'numpy' (the port's NumPy engine, on the host)")
    p.add_argument("--device", default=None,
                   help="device of --backend torch: cuda (default; an error "
                        "without a GPU) or cpu")
    p.add_argument("--sort", default="samples_per_sec",
                   help="result column to sort by (descending)")
    p.add_argument("--top", type=int, default=20,
                   help="print only the best N rows (0 = all)")
    p.add_argument("--csv", default=None, metavar="PATH",
                   help="also write the full table as CSV")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write the full table (plus sweep metadata) as JSON")
    return p


def grid_from_args(args: argparse.Namespace):
    """The chosen base grid with any CLI-provided axes substituted in,
    through :func:`repro_torch.core.scenarios.grid_from_spec`."""
    spec: dict = {"grid": args.grid}
    for key, val in (("workloads", args.workloads),
                     ("clusters", args.clusters),
                     ("workers", args.workers),
                     ("policies", args.policies),
                     ("collectives", args.collectives),
                     ("interconnects", args.interconnects),
                     ("het", args.het),
                     ("stragglers", args.stragglers),
                     ("sync_k", args.sync_k),
                     ("faults", args.faults)):
        if val:
            spec[key] = val
    if args.batch_per_gpu is not None:
        spec["batch_per_gpu"] = args.batch_per_gpu
    return grid_from_spec(spec)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_workloads:
        for name in known_workloads():
            print(name)
        return 0
    try:
        grid = grid_from_args(args)
    except (ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.sort and args.sort not in COLUMNS:
        print(f"error: unknown --sort column {args.sort!r}; "
              f"one of {', '.join(COLUMNS)}", file=sys.stderr)
        return 2
    if args.backend == "numpy":
        if args.device is not None:
            print("error: --device applies to --backend torch only",
                  file=sys.stderr)
            return 2
        where = "the host"
    else:
        try:
            where = str(resolve_device(args.device))
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    print(f"sweep: {len(grid)} scenarios "
          f"({len(grid.workloads)} workloads x {len(grid.clusters)} clusters "
          f"x {len(grid.worker_counts)} sizes x {len(grid.policies)} policies "
          f"x {len(grid.collectives)} collectives "
          f"x {len(grid.interconnects)} interconnects "
          f"x {len(grid.het_profiles)} het x {len(grid.stragglers)} "
          f"stragglers x {len(grid.sync_ks)} sync-k "
          f"x {len(grid.faults)} faults)")
    try:
        result = sweep(grid, backend=args.backend, device=args.device,
                       seed=args.seed)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"evaluated on {where} ({args.backend}) in {result.elapsed_s:.2f}s "
          f"({result.scenarios_per_sec:,.0f}/s; "
          f"{result.n_analytical} analytical, "
          f"{result.n_timeline} timeline, "
          f"{result.n_simulated} simulated)")

    rows = result.sorted_by(args.sort) if args.sort else result.rows
    limit = args.top if args.top and args.top > 0 else None
    print()
    print(result.format_table(rows, limit=limit))
    if limit is not None and len(rows) > limit:
        print(f"... {len(rows) - limit} more rows "
              f"(use --top 0 for all, --csv for the full table)")
    if args.csv:
        result.to_csv(args.csv)
        print(f"\nwrote {len(result)} rows to {args.csv}")
    if args.json:
        result.to_json(args.json)
        print(f"\nwrote {len(result)} rows to {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
