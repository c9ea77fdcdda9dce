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
  ``bench.L_BLOCK``: recurrentgemma-2b's L blocks) and at the
  encoder-decoder path's (``bench.WHISPER_ENC``, ``WHISPER_DEC``,
  ``WHISPER_CROSS``, ``LLAMA_G``, ``LLAMA_CROSS``, ``CROSS_DECODE``:
  bidirectional, and kv lengths that differ from q's), each build's calls
  as its own training path makes them: a build whose forward writes the
  float32 output (``out_f32``, o32) is timed writing it and its delta
  reading it, an older one its forward alone and its delta on the bfloat16
  output; ``CROSS_DECODE`` (decode: no gradient) the forward alone.  A
  build whose wrapper refuses a shape (one from before the kernels took
  ``Sq != Skv``) is left out of that shape's rows, with its reason;
* the ``rglru_fwd`` and ``rglru_bwd`` wrappers at ``bench.RGLRU_SLICE``
  (recurrentgemma-2b: B 2, S 1024, W 2560, bfloat16) and the ``wkv6_fwd``
  and ``wkv6_bwd`` wrappers at ``bench.WKV6_SLICE`` (rwkv6-1.6b: B 2, S
  1024, H 32, hd 64, bfloat16), each wrapper call whole (its launches and
  whatever it sums afterwards);
* one ``G`` layer of qwen1.5-4b and of internlm2-20b at published widths
  (B 2 x 1024 tokens, bfloat16, random parameters from seed 0), forward
  with a gradient wanted and backward, the model's attention going through
  each build's flash module in turn; beside the times, each build's bytes
  the forward keeps for the backward and the peak over one forward and
  backward, above what was allocated before.

Every build's outputs are held against this checkout's plain versions
(the max abs error is printed).  Run from the repository root on a machine
with a CUDA card::

    PYTHONPATH=src python -m repro_torch.kernels.compare --other build/parent

With ``--decode`` it times bfloat16 decode instead, each checkout whole in
a process of its own (:data:`DECODE_PROGRAM`, run with that checkout's
``src`` first on the path), in the order other, this, this, other, twice:
qwen1.5-4b (2 layers), recurrentgemma-2b (one RRL unit), rwkv6-1.6b (2
layers) and gemma3-1b (one LLLLLG unit) at their published widths, batch
4, 64 prompt tokens through ``prefill_via_decode``, 2 warm-up steps, then
32 greedy ``make_serve_step`` steps: the host ms a step (the time the step
takes to return, the device queue never full) and the step ms (synchronised
at the end), each checkout's median and the pairs this one was faster in.

It prints the card's name and power limit, one line per (shape, kernel,
build) and run, the median of each build's runs with the number of ABBA
pairs in which this build was faster, each build's CUDA kernels per call
with their device times (``bench.device_times``, L2 warm), and last the
card's line again and a JSON object with every time and every unit's
memory.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import inspect
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


FLASH_SHAPES = {"slice": bench.SLICE, "l_block": bench.L_BLOCK,
                "whisper_enc": bench.WHISPER_ENC, "whisper_dec": bench.WHISPER_DEC,
                "whisper_cross": bench.WHISPER_CROSS, "llama_g": bench.LLAMA_G,
                "llama_cross": bench.LLAMA_CROSS, "cross_decode": bench.CROSS_DECODE}
#: the archs whose ``G`` layer is timed whole (:func:`unit_cases`)
UNIT_ARCHS = ("qwen1.5-4b", "internlm2-20b")


def writes_o32(mod) -> bool:
    """Whether a build's flash forward can write its float32 output, which
    its training path's delta then reads."""
    return "out_f32" in inspect.signature(mod.fwd).parameters


def flash_cases(mods):
    """(label, {kernel: {build: (fn, want)}}) for each flash shape, each
    build's calls as its training path makes them (module docstring), for
    the builds whose forward takes the shape."""
    fa = mods["this"]["flash_attention"]
    for label, shp in FLASH_SHAPES.items():
        q, k, v, do = bench.make_inputs(**shp, seed=1)
        w, causal = shp["window"], shp["causal"]
        train = label not in bench.FORWARD_ONLY
        o, _, o32 = fa.plain_fwd(q, k, v, causal, w, out_f32=True)
        want_o = o.float()
        kernels = {"flash_fwd": {}, **({"flash_bwd_delta": {}} if train else {})}
        for build, m in mods.items():
            mod = m["flash_attention"]
            try:
                mod.fwd(q, k, v, causal, w)
            except ValueError as e:             # an older wrapper refusing Sq != Skv
                print(f"  {label:8s} {build:5s} build refuses the shape: {e}", flush=True)
                continue
            if train and writes_o32(mod):
                kernels["flash_fwd"][build] = (
                    lambda mod=mod: mod.fwd(q, k, v, causal, w, out_f32=True)[0], want_o)
                kernels["flash_bwd_delta"][build] = (
                    lambda mod=mod: mod.bwd_delta(o32, do), fa.plain_bwd_delta(o32, do))
            else:
                kernels["flash_fwd"][build] = (lambda mod=mod: mod.fwd(q, k, v, causal, w)[0],
                                               want_o)
                if train:
                    kernels["flash_bwd_delta"][build] = (
                        lambda mod=mod: mod.bwd_delta(o, do), fa.plain_bwd_delta(o, do))
        yield label, kernels


def rglru_cases(mods):
    """(label, {kernel: {build: (fn, want)}}) at recurrentgemma-2b's shape,
    as ``chip_smoke.time_rglru`` calls the wrappers (no h0; the states
    saved; a zero dh_last)."""
    rg = mods["this"]["rglru"]
    x, r, i, lam, _, dout, dh_last = bench.rglru_inputs(**bench.RGLRU_SLICE, seed=1)
    dh_last = torch.zeros_like(dh_last)
    out, _, states = rg.plain_fwd(x, r, i, lam, None, save_states=True)
    dx = rg.plain_bwd(x, r, i, lam, None, states, dout, dh_last)[0]
    kernels = {"rglru_fwd": {}, "rglru_bwd": {}}
    for build, m in mods.items():
        mod = m["rglru"]
        kernels["rglru_fwd"][build] = (
            lambda mod=mod: mod.fwd(x, r, i, lam, None, save_states=True)[0], out.float())
        kernels["rglru_bwd"][build] = (
            lambda mod=mod: mod.bwd(x, r, i, lam, None, states, dout, dh_last)[0], dx.float())
    yield "rglru", kernels


def wkv6_cases(mods):
    """(label, {kernel: {build: (fn, want)}}) at rwkv6-1.6b's shape, as
    ``chip_smoke.time_wkv6`` calls the wrappers (no initial state; a zero
    final-state cotangent)."""
    wk = mods["this"]["wkv6"]
    r, k, v, w, u, _, dout, ds_last = bench.wkv6_inputs(**bench.WKV6_SLICE, seed=1)
    ds_last = torch.zeros_like(ds_last)
    out, _, ckpt = wk.plain_fwd(r, k, v, w, u, None, save_ckpt=True)
    dr = wk.plain_bwd(r, k, v, w, u, ckpt, dout, ds_last)[0]
    kernels = {"wkv6_fwd": {}, "wkv6_bwd": {}}
    for build, m in mods.items():
        mod = m["wkv6"]
        kernels["wkv6_fwd"][build] = (
            lambda mod=mod: mod.fwd(r, k, v, w, u, None, save_ckpt=True)[0], out.float())
        kernels["wkv6_bwd"][build] = (
            lambda mod=mod: mod.bwd(r, k, v, w, u, ckpt, dout, ds_last)[0], dr.float())
    yield "wkv6", kernels


@contextlib.contextmanager
def attention_through(mod):
    """The model's attention (``ops.attention``) through the flash module
    ``mod`` for the duration."""
    from repro_torch.kernels import ops

    old, ops.fa = ops.fa, mod
    try:
        yield
    finally:
        ops.fa = old


def unit_cases(mods, memory: dict):
    """(label, {"unit_fwd" | "unit_bwd": {build: (fn, want)}}) for one ``G``
    layer of each of :data:`UNIT_ARCHS` (module docstring), held against
    this build's output and gradient of the layer input.  ``memory`` gets,
    per label and build, the forward's kept bytes and the peak."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks as Bk
    from repro_torch.models import transformer as T

    for arch in UNIT_ARCHS:
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(0)
        p = Bk.init_block(cfg, "G", gen, "cuda")
        x = torch.randn(2, 1024, cfg.d_model, generator=gen, device="cuda").to(cfg.dtype)
        dy = torch.randn(x.shape, generator=gen, device="cuda").to(cfg.dtype)
        leaves = [x.requires_grad_(), *(t.requires_grad_() for _, t in T.leaf_order(p))]
        label = f"{arch} G"
        # one pass first, so that what is allocated at first use (cuBLAS's
        # workspace) counts in neither build's memory
        torch.autograd.grad(Bk.apply_block(cfg, "G", p, x)[0], leaves, dy)
        kernels, want = {"unit_fwd": {}, "unit_bwd": {}}, None
        for build in ("this", "other"):         # this first: its outputs are the wants
            mod = mods[build]["flash_attention"]

            def fwd(mod=mod):
                with attention_through(mod):
                    return Bk.apply_block(cfg, "G", p, x)[0]

            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            y = fwd()
            torch.cuda.synchronize()
            kept = torch.cuda.memory_allocated() - base
            dx = torch.autograd.grad(y, leaves, dy, retain_graph=True)[0]
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            memory.setdefault(label, {})[build] = {"kept_bytes": kept, "peak_bytes": peak}
            print(f"  {label:8s} {build:5s} forward keeps {kept / 2**20:.1f} MiB for the "
                  f"backward; peak over forward and backward {peak / 2**20:.1f} MiB",
                  flush=True)
            if want is None:
                want = (y.detach().float(), dx.float())
            kernels["unit_fwd"][build] = (fwd, want[0])
            kernels["unit_bwd"][build] = (
                lambda y=y: torch.autograd.grad(y, leaves, dy, retain_graph=True)[0], want[1])
            del dx
        yield label, kernels
        del p, x, dy, leaves, kernels, want, y
        torch.cuda.empty_cache()


#: the decode timing one checkout runs in its own process (``--decode``);
#: it uses only what every checkout since decode was ported has
DECODE_PROGRAM = r"""
import dataclasses, json, time
import torch
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.launch.steps import init_params, make_serve_step
from repro_torch.models import transformer as T

kernels.load_libraries()
out = {}
for arch, depth in (("qwen1.5-4b", 2), ("recurrentgemma-2b", 3), ("rwkv6-1.6b", 2),
                    ("gemma3-1b", 6)):
    cfg = dataclasses.replace(get_config(arch), num_layers=depth,
                              dtype=torch.bfloat16).validate()
    params = init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, 64), generator=g, device="cuda")
    logits, cache = T.prefill_via_decode(cfg, params, prompt, 64 + 2 + 32)
    serve = make_serve_step(cfg)
    state = {"token": logits[:, -1].argmax(dim=-1), "pos": 64}

    def step():
        lg, _ = serve(params, {"cache": cache, **state})
        state["token"], state["pos"] = lg.argmax(dim=-1), state["pos"] + 1

    step(); step()
    torch.cuda.synchronize()
    host, t0 = 0.0, time.perf_counter()
    for _ in range(32):
        h0 = time.perf_counter()
        step()
        host += time.perf_counter() - h0
    torch.cuda.synchronize()
    out[arch] = {"host_ms": host / 32 * 1e3, "step_ms": (time.perf_counter() - t0) / 32 * 1e3}
    del params, cache, logits
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def decode_main(other: Path) -> int:
    """``--decode``: the module docstring's decode timing, ABBA."""
    import os
    import subprocess

    roots = {"this": Path(__file__).resolve().parents[3], "other": other.resolve()}
    runs: dict = {}
    for build in ("other", "this", "this", "other") * 2:
        root = roots[build]
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        r = subprocess.run([sys.executable, "-c", DECODE_PROGRAM], cwd=root, env=env,
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout[-3000:], r.stderr[-3000:], flush=True)
            return 1
        res = json.loads(r.stdout.strip().splitlines()[-1])
        for arch, t in res.items():
            print(f"  decode {arch:18s} {build:5s} host {t['host_ms']:.4f} ms a step, "
                  f"step {t['step_ms']:.4f} ms", flush=True)
            for key, ms in t.items():
                runs.setdefault(arch, {}).setdefault(key, {}).setdefault(build, []).append(ms)
    for arch, keys in runs.items():
        for key, builds in keys.items():
            wins = sum(a < b for a, b in zip(builds["this"], builds["other"]))
            print(f"  decode {arch:18s} {key:7s} median this "
                  f"{statistics.median(builds['this']):.4f} other "
                  f"{statistics.median(builds['other']):.4f} ms; this faster in {wins} of "
                  f"{len(builds['this'])} pairs", flush=True)
    print(bench.card_line(), flush=True)
    print(json.dumps({"decode": runs}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="root of the other checkout")
    ap.add_argument("--decode", action="store_true",
                    help="time bfloat16 decode of each checkout in its own process")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(bench.card_line(), flush=True)
    if args.decode:
        return decode_main(args.other)
    mods = {"this": {name: importlib.import_module(f"repro_torch.kernels.{name}")
                     for name in MODULES},
            "other": {name: load_module(args.other.resolve(), name) for name in MODULES}}
    for m in mods.values():
        for mod in m.values():
            mod.load_library()
    out: dict = {}
    memory: dict = {}
    for case in (flash_cases(mods), rglru_cases(mods), wkv6_cases(mods),
                 unit_cases(mods, memory)):
        for label, kernels in case:
            for build in ("other", "this", "this", "other") * ROUNDS:
                for kernel, builds in kernels.items():
                    if build not in builds:
                        continue
                    fn, want = builds[build]
                    err = (fn().float() - want).abs().max().item()
                    ms = bench.time_ms(fn)
                    out.setdefault(label, {}).setdefault(kernel, {}).setdefault(
                        build, []).append(ms)
                    print(f"  {label:8s} {kernel:16s} {build:5s} {ms:.4f} ms "
                          f"max_abs_err {err:.3g}", flush=True)
            for kernel, builds in out[label].items():
                medians = " ".join(f"{build} {statistics.median(ms):.4f}"
                                   for build, ms in builds.items())
                wins = "" if len(builds) < 2 else "; this faster in " \
                    f"{sum(a < b for a, b in zip(builds['this'], builds['other']))} of " \
                    f"{len(builds['this'])} pairs"
                print(f"  {label:8s} {kernel:16s} median {medians} ms{wins}", flush=True)
                for build, (fn, _) in kernels[kernel].items():
                    times = bench.device_times(fn)
                    bench.print_profile(f"{label} {kernel} {build}'s CUDA kernels (L2 warm), "
                                        f"{sum(times.values()):.4f} ms device in all", times)
            del kernels
            torch.cuda.empty_cache()
    print(bench.card_line(), flush=True)
    print(json.dumps({"ms": out, "memory": memory}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
