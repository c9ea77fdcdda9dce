"""Time two builds of the flash forward and delta kernels on one card.

Builds this checkout's ``src/repro_torch/csrc/flash_attention.cu`` and
another checkout's (for example the parent commit, unpacked with ``git
archive`` into a directory that ``.gitignore`` lists), and times
``flash_fwd`` and ``flash_bwd_delta`` of each in bfloat16 at
``chip_smoke.py``'s two main-path shapes (qwen1.5-4b's G blocks,
recurrentgemma-2b's L blocks), five times in the order other, this, this,
other, with three timers:

* ``back_to_back``: 20 calls between two events, the host launching while
  the device runs, L2 warm;
* ``queued``: the same after the stream sleeps ~2 ms, so that every launch
  is queued before the first starts;
* ``cold``: ``chip_smoke.time_ms``, L2 refilled before each call and only
  the calls timed (the ``ms`` of ``chip_smoke.py``'s kernels line).

Both builds' outputs are also held against the plain versions.  Run from
the repository root on a machine with a CUDA card::

    python3 tools/compare_flash.py --other build/parent

It prints the card's name and power limit, one line per (shape, kernel,
build, timer) and run, the median of each build's ten runs with the
number of ABBA pairs in which this build was faster, and a JSON object
with every time last.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.build import load  # noqa: E402


def back_to_back(fn, iters=20, queued=False) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(chip_smoke.QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: the two entry points timed; both builds give them the same C interface
RUNS = ("flash_fwd", "flash_bwd_delta")
TIMERS = {"back_to_back": back_to_back,
          "queued": lambda fn: back_to_back(fn, queued=True),
          "cold": chip_smoke.time_ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the other checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    libs = {"this": fa.load_library(),
            "other": load(args.other / "src" / "repro_torch" / "csrc" / "flash_attention.cu",
                          {name: fa.SIGNATURES[name] for name in RUNS})}
    out = {}
    for label, shp in (("slice", chip_smoke.SLICE), ("l_block", chip_smoke.L_BLOCK)):
        q, k, v, do = chip_smoke.make_inputs(**shp, seed=1)
        w = shp["window"]
        o, lse = fa.plain_fwd(q, k, v, True, w)
        want = {"flash_fwd": o.float(), "flash_bwd_delta": fa.plain_bwd_delta(o, do)}
        runs = {"flash_fwd": lambda: fa.fwd(q, k, v, True, w)[0],
                "flash_bwd_delta": lambda: fa.bwd_delta(o, do)}
        for build in ("other", "this", "this", "other") * 5:
            # the wrappers launch through the loaded library
            fa._lib = libs[build]
            for name, fn in runs.items():
                err = (fn().float() - want[name]).abs().max().item()
                for timer, time_fn in TIMERS.items():
                    ms = time_fn(fn)
                    out.setdefault(label, {}).setdefault(name, {}).setdefault(
                        build, {}).setdefault(timer, []).append(ms)
                    print(f"  {label:8s} {name:16s} {build:5s} {timer:12s} {ms:.4f} ms "
                          f"max_abs_err {err:.3g}", flush=True)
        fa._lib = libs["this"]
        for name, builds in out[label].items():
            for timer in TIMERS:
                this, other = builds["this"][timer], builds["other"][timer]
                wins = sum(a < b for a, b in zip(this, other))
                print(f"  {label:8s} {name:16s} {timer:12s} median other "
                      f"{statistics.median(other):.4f} this {statistics.median(this):.4f} ms; "
                      f"this faster in {wins} of {len(this)} pairs", flush=True)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
