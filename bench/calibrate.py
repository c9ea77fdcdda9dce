"""The readings a cell's limits are set from, on the card, in one process.

    python3 bench/calibrate.py --workload internlm2-20b.train.s4096 \\
        --seeds 11 12 13 --control 11 12 13 --fault 11 12 13 [--witness]

For each seed: the program's first steps as a run's set-up drives them,
the float32 reference following them, and the three numbers of
:func:`bench.check.gaps`; for a ``--control`` seed also the float8 control
(the reference with float8 matrix products and bfloat16 parameters) against
the reference, and for a ``--fault`` seed the reference with half of each
batch left out; with ``--witness`` both sides also against the reference
followed in float64.  ``--dryrun`` prints instead, for each cell named, the
FLOPs the program's shape-only lowering counts (no recompute) beside
:func:`bench.cost.step.train_step_flops`.  One JSON line per reading."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import check, harness  # noqa: E402
from bench.cost.step import train_step_flops  # noqa: E402
from bench.weights import batches  # noqa: E402


def emit(out, **row):
    line = json.dumps(row)
    print(line, flush=True)
    out.write(line + "\n")
    out.flush()


def seeds(spec, args, out):
    c, t = spec["config"], spec["traffic"]
    fam = harness.family(c)
    for seed in args.seeds:
        t0 = time.perf_counter()
        prog = harness.build(spec, seed, "cuda")
        readings = harness.warm(prog, t["check_steps"], seed, "cuda")
        peak = torch.cuda.max_memory_allocated()
        harness.release(prog)
        t1 = time.perf_counter()
        bs = [b for _, b in zip(range(t["check_steps"]),
                                batches(seed, c["vocab_size"], t["rows"], t["seq_len"]))]
        ref = check.follow(fam, c, seed, bs, t["lr"], t["momentum"], "cuda")
        t2 = time.perf_counter()
        if args.witness:
            exact = check.follow(fam, c, seed, bs, t["lr"], t["momentum"], "cuda",
                                 dtype=torch.float64)
            emit(out, seed=seed, what="float64", program=check.gaps(readings, exact),
                 reference=check.gaps(ref, exact), worst_program=worst(readings, exact),
                 worst_reference=worst(ref, exact))
        emit(out, seed=seed, what="program", gaps=check.gaps(readings, ref),
             loss=readings["loss"], ref_loss=ref["loss"], program_s=t1 - t0,
             reference_s=t2 - t1, peak_gib=peak / 2**30, worst=worst(readings, ref))
        if seed in args.control:
            ctl = check.follow(fam, c, seed, bs, t["lr"], t["momentum"], "cuda",
                               matmul="fp8", store=torch.bfloat16)
            emit(out, seed=seed, what="control", gaps=check.gaps(ctl, ref),
                 worst=worst(ctl, ref))
        if seed in args.fault:
            half = check.follow(fam, c, seed, bs, t["lr"], t["momentum"], "cuda",
                                fault="half_batch")
            emit(out, seed=seed, what="half_batch", gaps=check.gaps(half, ref))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def worst(a, b, n=4):
    """The leaves with the largest gaps, for the look into a reading."""
    rows = {}
    for k in ("grad", "change"):
        rel = sorted(((abs(a[k][x] - b[k][x]) / max(b[k][x], 1e-30), x, a[k][x], b[k][x])
                      for x in b[k]), reverse=True)[:n]
        rows[k] = [[x, p, r] for _, x, p, r in rel]
    return rows


def dryrun(cells, out):
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun as D

    for cell in cells:
        spec = harness.load_spec(cell, ROOT)
        c, t = spec["config"], spec["traffic"]
        rec = D.lower(harness.program_config(c),
                      InputShape(cell, t["seq_len"], t["rows"], "train"), remat=False)
        flops = rec["cost_analysis"]["flops"]
        ours = train_step_flops(c, t["rows"], t["seq_len"])
        emit(out, cell=cell, lowered_flops=flops, frozen_flops=ours, ratio=ours / flops,
             memory=rec["memory"])


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload")
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault", type=int, nargs="*", default=[])
    ap.add_argument("--dryrun", nargs="*")
    ap.add_argument("--witness", action="store_true",
                    help="also follow in float64, and compare both sides with it")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "calibrate.jsonl"))
    args = ap.parse_args()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as out:
        if args.dryrun:
            dryrun(args.dryrun, out)
        else:
            spec = harness.load_spec(args.workload, ROOT)
            emit(out, workload=args.workload, traffic=spec["traffic"],
                 dtype=spec["config"]["dtype"],
                 device=torch.cuda.get_device_name(), torch=torch.__version__)
            seeds(spec, args, out)


if __name__ == "__main__":
    main()
