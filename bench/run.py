"""Run one benchmark cell and print its result as the last line of stdout.

    python3 bench/run.py --workload internlm2-20b.train.s4096 --seed 7 \\
        --seconds 20 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a traced run.  Needs a CUDA card; exits with code 2
and prints no result without one, or without the program beside the
benchmark (``src/repro_torch``), and with code 3 if JAX or the JAX package
was loaded by the time the run ends."""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import harness

    spec = harness.load_spec(args.workload, ROOT)
    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as err:
        print(f"the program is not beside the benchmark: {err}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, lines = harness.run(spec, args.seed, args.seconds, bool(args.trace),
                                device="cuda", t0=T0)
    bad = harness.loaded_forbidden()
    if bad:
        print(f"modules loaded that the run may not hold: {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
