"""Time two builds of the port's kernels on one card, in one process.

Loads this checkout's kernel modules and the same modules of another
checkout (for example the parent commit, unpacked with ``git archive`` into
a directory that ``.gitignore`` lists), each module from its own file with
its own wrappers and its own library built from its own source, so two
builds with different C interfaces compare as their callers see them.  Then
it times, five times in the order other, this, this, other, each call with
:func:`repro_torch.kernels.bench.time_ms` (L2 refilled before each call and
only the calls timed, the ``ms`` of ``chip_smoke.py``'s kernels line):

* ``flash_fwd`` and ``flash_bwd_delta`` in bfloat16 at the two flash shapes
  of the main paths (``bench.SLICE``: qwen1.5-4b's G blocks;
  ``bench.L_BLOCK``: recurrentgemma-2b's L blocks);
* the ``rglru_fwd`` and ``rglru_bwd`` wrappers at ``bench.RGLRU_SLICE``
  (recurrentgemma-2b: B 2, S 1024, W 2560, bfloat16) and the ``wkv6_fwd``
  and ``wkv6_bwd`` wrappers at ``bench.WKV6_SLICE`` (rwkv6-1.6b: B 2, S
  1024, H 32, hd 64, bfloat16), each wrapper call whole (its launches and
  whatever it sums afterwards).

Every build's outputs are held against this checkout's plain versions
(the max abs error is printed).  Run from the repository root on a machine
with a CUDA card::

    PYTHONPATH=src python -m repro_torch.kernels.compare --other build/parent

It prints the card's name and power limit, one line per (shape, kernel,
build) and run, the median of each build's runs with the number of ABBA
pairs in which this build was faster, each build's CUDA kernels per call
with their device times (``bench.device_times``, L2 warm), and last the
card's line again and a JSON object with every time.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import torch

from repro_torch.kernels import bench

#: the kernel modules this tool compares
MODULES = ("flash_attention", "rglru", "wkv6")
ROUNDS = 5


def load_module(root: Path, name: str):
    """``src/repro_torch/kernels/<name>.py`` of the checkout at ``root``,
    imported as a module of its own (its library builds from its own
    ``csrc``)."""
    path = root / "src" / "repro_torch" / "kernels" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"compare_{root.name}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flash_cases(mods):
    """(label, {kernel: (want, {build: fn})}) for each flash shape."""
    fa = mods["this"]["flash_attention"]
    for label, shp in (("slice", bench.SLICE), ("l_block", bench.L_BLOCK)):
        q, k, v, do = bench.make_inputs(**shp, seed=1)
        w = shp["window"]
        o, _ = fa.plain_fwd(q, k, v, True, w)
        want = {"flash_fwd": o.float(), "flash_bwd_delta": fa.plain_bwd_delta(o, do)}
        runs = {name: {} for name in want}
        for build, m in mods.items():
            mod = m["flash_attention"]
            runs["flash_fwd"][build] = lambda mod=mod: mod.fwd(q, k, v, True, w)[0]
            runs["flash_bwd_delta"][build] = lambda mod=mod: mod.bwd_delta(o, do)
        yield label, {name: (want[name], runs[name]) for name in want}


def rglru_cases(mods):
    """(label, {kernel: (want, {build: fn})}) at recurrentgemma-2b's shape,
    as ``chip_smoke.time_rglru`` calls the wrappers (no h0; the states
    saved; a zero dh_last)."""
    rg = mods["this"]["rglru"]
    x, r, i, lam, _, dout, dh_last = bench.rglru_inputs(**bench.RGLRU_SLICE, seed=1)
    dh_last = torch.zeros_like(dh_last)
    out, _, states = rg.plain_fwd(x, r, i, lam, None, save_states=True)
    dx = rg.plain_bwd(x, r, i, lam, None, states, dout, dh_last)[0]
    runs = {"rglru_fwd": {}, "rglru_bwd": {}}
    for build, m in mods.items():
        mod = m["rglru"]
        runs["rglru_fwd"][build] = lambda mod=mod: mod.fwd(x, r, i, lam, None,
                                                           save_states=True)[0]
        runs["rglru_bwd"][build] = lambda mod=mod: mod.bwd(x, r, i, lam, None, states, dout,
                                                           dh_last)[0]
    yield "rglru", {"rglru_fwd": (out.float(), runs["rglru_fwd"]),
                    "rglru_bwd": (dx.float(), runs["rglru_bwd"])}


def wkv6_cases(mods):
    """(label, {kernel: (want, {build: fn})}) at rwkv6-1.6b's shape, as
    ``chip_smoke.time_wkv6`` calls the wrappers (no initial state; a zero
    final-state cotangent)."""
    wk = mods["this"]["wkv6"]
    r, k, v, w, u, _, dout, ds_last = bench.wkv6_inputs(**bench.WKV6_SLICE, seed=1)
    ds_last = torch.zeros_like(ds_last)
    out, _, ckpt = wk.plain_fwd(r, k, v, w, u, None, save_ckpt=True)
    dr = wk.plain_bwd(r, k, v, w, u, ckpt, dout, ds_last)[0]
    runs = {"wkv6_fwd": {}, "wkv6_bwd": {}}
    for build, m in mods.items():
        mod = m["wkv6"]
        runs["wkv6_fwd"][build] = lambda mod=mod: mod.fwd(r, k, v, w, u, None, save_ckpt=True)[0]
        runs["wkv6_bwd"][build] = lambda mod=mod: mod.bwd(r, k, v, w, u, ckpt, dout, ds_last)[0]
    yield "wkv6", {"wkv6_fwd": (out.float(), runs["wkv6_fwd"]),
                   "wkv6_bwd": (dr.float(), runs["wkv6_bwd"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="root of the other checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(bench.card_line(), flush=True)
    mods = {"this": {name: importlib.import_module(f"repro_torch.kernels.{name}")
                     for name in MODULES},
            "other": {name: load_module(args.other.resolve(), name) for name in MODULES}}
    for m in mods.values():
        for mod in m.values():
            mod.load_library()
    out: dict = {}
    for cases in (flash_cases, rglru_cases, wkv6_cases):
        for label, kernels in cases(mods):
            for build in ("other", "this", "this", "other") * ROUNDS:
                for kernel, (want, fns) in kernels.items():
                    err = (fns[build]().float() - want).abs().max().item()
                    ms = bench.time_ms(fns[build])
                    out.setdefault(label, {}).setdefault(kernel, {}).setdefault(
                        build, []).append(ms)
                    print(f"  {label:8s} {kernel:16s} {build:5s} {ms:.4f} ms "
                          f"max_abs_err {err:.3g}", flush=True)
            for kernel, builds in out[label].items():
                new, old = builds["this"], builds["other"]
                wins = sum(a < b for a, b in zip(new, old))
                print(f"  {label:8s} {kernel:16s} median other {statistics.median(old):.4f} "
                      f"this {statistics.median(new):.4f} ms; "
                      f"this faster in {wins} of {len(new)} pairs", flush=True)
                for build, fn in kernels[kernel][1].items():
                    bench.print_profile(f"{label} {kernel} {build}'s CUDA kernels (L2 warm)",
                                        bench.device_times(fn))
            torch.cuda.empty_cache()
    print(bench.card_line(), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
