"""Model vs. measurement on the port's own traces (the paper's Fig. 4 /
§V-D closed loop).

``python -m repro_torch.measure --arch <a>`` writes ``<a>.json`` (the
measured seconds/iteration per sync policy, ``t_u``, the alpha-beta fit of
the all-reduce) and ``<a>.trace`` (the per-layer trace).  From those two
files alone this module predicts each policy's iteration time with the
port's copy of the DAG model and reports |predicted - measured| /
measured per policy: the measured half of
``benchmarks/bench_model_vs_measured.py`` (``predict_policies`` and its
error loop), on the port's measurements::

    python -m repro_torch.measure.model_vs_measured --out-dir <dir> \\
        --archs qwen1.5-4b,gemma3-1b [--json PATH] [--assert-error-ceiling PCT]

It reads files only and runs on any host.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

from repro_torch.comm.sync import DEFAULT_BUCKET_BYTES
from repro_torch.core.predictor import predict_sync_policy
from repro_torch.measure.calibrate import comm_scale_from_fit
from repro_torch.traces.format import read_trace


def predict_policies(doc: dict, trace_path: str | Path) -> dict[str, float]:
    """Model predictions (seconds/iteration) for every measured policy,
    from the trace and the measured ``t_u`` and alpha-beta fit alone; the
    modelled ``bucketed`` policy uses the threshold the step ran with
    (``comm.sync.DEFAULT_BUCKET_BYTES``)."""
    costs = read_trace(trace_path).to_iteration_costs(t_u=doc["t_update_s"])
    fit = doc["allreduce_fit"]
    comm_scale = comm_scale_from_fit(fit["latency_s"], fit["bandwidth_bytes_per_s"])
    return {
        pol: predict_sync_policy(costs, doc["n_devices"], pol, comm_scale=comm_scale,
                                 bucket_bytes=DEFAULT_BUCKET_BYTES)
        for pol in doc["policy_times_s"]
    }


def model_error(doc: dict, trace_path: str | Path) -> dict[str, dict[str, float]]:
    """Per measured policy: ``measured_s``, ``predicted_s`` and
    ``error_pct`` = |predicted - measured| / measured * 100 (inf when the
    measured time is 0)."""
    out = {}
    for pol, pred in predict_policies(doc, trace_path).items():
        meas = doc["policy_times_s"][pol]
        err = abs(pred - meas) / meas * 100 if meas else math.inf
        out[pol] = {"measured_s": meas, "predicted_s": pred, "error_pct": err}
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="repro_torch.measure.model_vs_measured",
        description="Score the DAG model against measured runs (paper Fig. 4).")
    p.add_argument("--out-dir", required=True,
                   help="the directory python -m repro_torch.measure wrote")
    p.add_argument("--archs", required=True,
                   help="comma-separated archs with <arch>.json and <arch>.trace there")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="write the per-arch, per-policy errors here")
    p.add_argument("--assert-error-ceiling", type=float, default=None, metavar="PCT",
                   help="exit 1 if any per-policy error exceeds PCT percent")
    args = p.parse_args(argv)
    out_dir = Path(args.out_dir)
    archs = [a.strip() for a in args.archs.split(",") if a.strip()]
    result: dict = {"archs": {}}
    max_err = 0.0
    for arch in archs:
        doc = json.loads((out_dir / f"{arch}.json").read_text())
        rows = model_error(doc, out_dir / f"{arch}.trace")
        result["archs"][arch] = {"device": doc["device"], "allreduce_fit": doc["allreduce_fit"],
                                 "t_update_s": doc["t_update_s"], "policies": rows}
        for pol, row in rows.items():
            print(f"{arch:18s} {pol:9s} measured {row['measured_s']:.6g} s  predicted "
                  f"{row['predicted_s']:.6g} s  error {row['error_pct']:.1f} %")
            max_err = max(max_err, row["error_pct"])
    result["max_error_pct"] = max_err
    if args.json:
        Path(args.json).write_text(json.dumps(result, indent=2))
    print(f"max per-policy error: {max_err:.1f} %")
    if args.assert_error_ceiling is not None and max_err > args.assert_error_ceiling:
        print(f"error {max_err:.1f} % exceeds the ceiling of {args.assert_error_ceiling:g} %",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
