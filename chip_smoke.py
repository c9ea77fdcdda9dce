"""Drives the port on one NVIDIA H100: ``python3 chip_smoke.py``.

Phases, in order; any failure ends the script with a non-zero code:

1. print the card's name and power limit (``nvidia-smi``);
2. build every kernel library from ``src/repro_torch/csrc`` (flash
   attention, RG-LRU and wkv6, one ``nvcc`` each, at once); print the flash
   forward and backward kernels' ``-Xptxas -v`` lines, each bfloat16
   tensor-core instantiation's registers, shared memory and CTAs per SM,
   and their HMMA count in the SASS (fails on a spill or a tensor-core
   kernel without HMMA);
3. hold every flash kernel (forward, delta, dq, dk/dv) against its plain
   PyTorch version on the card, element by element, at qwen1.5-4b's
   shape, at recurrentgemma-2b's local-attention shape (hd 256, one KV
   head) and at a GQA + window (hd 256) shape in bfloat16 and in float32,
   and at a ragged and two more float32 shapes, and in bfloat16 at hd 64,
   hd 32 ragged and hd 256 ragged with two kv heads (the tensor-core
   backward's other instantiations); hold the differentiable
   attention against autograd through ``ref.attention``; hold the RG-LRU
   forward against its plain version and its backward against autograd
   through ``ref.rglru``, at recurrentgemma-2b's shape in bfloat16 and
   float32, at a ragged shape with a carried state and where sigmoid(r) ~ 0;
   hold the wkv6 forward against its plain version and its backward
   against autograd through ``ref.wkv6``, at rwkv6-1.6b's shape in bfloat16
   and float32, at a ragged shape (hd 32) with a carried state, at strong
   decays (w down to 1e-3) and where bfloat16 rounds w to exactly 1; hold
   a reduced qwen1.5-4b's, recurrentgemma-2b's and rwkv6-1.6b's loss and
   gradients on the card (through the kernels) against the same model on
   the CPU (plain versions); run the bfloat16 flash forward and backward
   twice at the main paths' shapes and require bitwise-equal o, lse, dq, dk
   and dv;
4. time each kernel, its plain version and the PyTorch library call that
   computes the same function (``scaled_dot_product_attention`` and its
   backward, ``torch.linalg.vecdot`` for delta, timed here only and never
   called by the port; none for the RG-LRU and wkv6 scans), each with L2
   refilled before every call, at the main paths' shapes, and compute each
   kernel's bound;
5. run ``repro_torch.measure`` for qwen1.5-4b (2 units), recurrentgemma-2b
   (one RRL unit) and rwkv6-1.6b (2 units) at their published widths with 2
   gloo ranks on the card and all three sync policies; check each written
   trace, the counted all-reduce bytes and that the three policies leave
   the same momentum;
6. check that every kernel of each path launched during its run (the
   counters are set to 0 before each);
7. print the ``kernels`` line, then the ``ok`` line last.

It imports nothing of JAX and nothing of the reference package ``repro``.
"""
from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# Published dense peaks of one H100 SXM at its full 700 W (NVIDIA's data
# sheet): HBM bytes/s and FLOP/s by input type (bf16 on the tensor cores,
# float32 on the CUDA cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

#: Element-wise limits (rtol, atol): |got - want| <= rtol * |want| + atol *
#: rms(want), by the output's dtype.  Kernel and plain version both compute
#: in float32, so in bfloat16 they differ by at most one rounding step of the
#: output (2^-7 of the value; readings of 3.9e-3 abs at values in [0.5, 1));
#: atol only keeps entries at zero from dividing by zero.  float32: the
#: repository's f32 kernel tolerance (tests/test_kernels.py ``_tol``).
LIMITS = {torch.bfloat16: (1e-2, 1e-3), torch.float32: (2e-4, 2e-4)}
#: Autograd through the kernels in bfloat16 against autograd through
#: ``ref.attention`` in float32 on the same values: the kernels' delta =
#: rowsum(dO * O) reads the output rounded to bfloat16, the float32 softmax
#: backward the exact one, an error in dq and dk that is not proportional
#: to each entry.
AUTOGRAD_BF16_LIMIT = (1e-2, 1e-1)
#: Per-leaf norm of the f32 momentum after the timed steps: the three
#: policies agree to bf16 reduction rounding (at_end and wfbp reduce bf16
#: gradients, bucketed f32); a leaf left unsynchronized holds one rank's own
#: gradient instead of the mean over both shards.
MOMENTUM_RTOL = 1e-2

# The main paths' attention shapes at batch_per_gpu 2, seq 1024: qwen1.5-4b's
# G blocks, and recurrentgemma-2b's L blocks (window 2048 >= S: causal only).
SLICE = dict(B=2, S=1024, H=20, K=20, hd=128, window=None, dtype=torch.bfloat16)
L_BLOCK = dict(B=2, S=1024, H=10, K=1, hd=256, window=2048, dtype=torch.bfloat16)
CHECK_SHAPES = [
    ("slice", SLICE),
    ("l_block", L_BLOCK),
    ("f32_l_block", dict(L_BLOCK, dtype=torch.float32)),
    ("gqa_window", dict(B=1, S=2048, H=4, K=1, hd=256, window=512, dtype=torch.bfloat16)),
    ("ragged", dict(B=2, S=1000, H=8, K=4, hd=128, window=None, dtype=torch.bfloat16)),
    ("f32_slice", dict(SLICE, dtype=torch.float32)),
    ("f32_gqa_window", dict(B=1, S=2048, H=4, K=1, hd=256, window=512, dtype=torch.float32)),
    ("f32_hd64", dict(B=2, S=512, H=4, K=2, hd=64, window=100, dtype=torch.float32)),
    ("f32_hd32_ragged", dict(B=1, S=300, H=2, K=1, hd=32, window=32, dtype=torch.float32)),
    # the bfloat16 backward's tensor-core instantiations the shapes above
    # leave out: hd 64, hd 32 ragged, hd 256 ragged with two kv heads
    ("hd64", dict(B=2, S=512, H=4, K=2, hd=64, window=100, dtype=torch.bfloat16)),
    ("hd32_ragged", dict(B=1, S=300, H=2, K=1, hd=32, window=32, dtype=torch.bfloat16)),
    ("hd256_ragged_gqa", dict(B=1, S=1000, H=8, K=2, hd=256, window=None,
                              dtype=torch.bfloat16)),
]
# recurrentgemma-2b's RG-LRU shape at batch_per_gpu 2, seq 1024 (W = rnn_width).
RGLRU_SLICE = dict(B=2, S=1024, W=2560, dtype=torch.bfloat16)
RGLRU_SHAPES = [
    ("slice", RGLRU_SLICE),
    ("f32_slice", dict(RGLRU_SLICE, dtype=torch.float32)),
    ("f32_ragged_h0", dict(B=2, S=1000, W=200, dtype=torch.float32, h0=True)),
    ("f32_a_near_1", dict(B=2, S=1024, W=256, dtype=torch.float32, h0=True, r_shift=-40.0)),
]
# rwkv6-1.6b's wkv shape at batch_per_gpu 2, seq 1024 (32 heads of 64).  decay:
# "mild" exp(-exp(N(0, 1) - 3)) as the repository's kernel tests, "strong" w
# uniform in [1e-3, 0.2], "one" exp(-exp(N(0, 1) - 12)), which bfloat16
# rounds to exactly 1.0 (checked where the inputs are made).
WKV6_SLICE = dict(B=2, S=1024, H=32, hd=64, dtype=torch.bfloat16)
WKV6_SHAPES = [
    ("slice", WKV6_SLICE),
    ("f32_slice", dict(WKV6_SLICE, dtype=torch.float32)),
    ("f32_ragged_state", dict(B=2, S=1000, H=4, hd=32, dtype=torch.float32, state=True)),
    ("f32_strong_decay", dict(B=2, S=1024, H=4, hd=64, dtype=torch.float32, decay="strong")),
    ("w_one", dict(B=2, S=512, H=4, hd=64, dtype=torch.bfloat16, decay="one")),
]
_COMMON = ["--seq-len", "1024", "--batch-per-gpu", "2", "--devices", "2", "--repeats", "3",
           "--step-iters", "3"]
#: The main paths, each run with the kernel counters set to 0 just before:
#: arch -> (CLI arguments, the kernels its run must launch).
MAIN_PATHS = {
    "qwen1.5-4b": (["--arch", "qwen1.5-4b", "--num-layers", "2", *_COMMON],
                   ("flash_fwd", "flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkdv")),
    "recurrentgemma-2b": (["--arch", "recurrentgemma-2b", "--num-layers", "3", *_COMMON],
                          ("flash_fwd", "flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkdv",
                           "rglru_fwd", "rglru_bwd")),
    "rwkv6-1.6b": (["--arch", "rwkv6-1.6b", "--num-layers", "2", *_COMMON],
                   ("wkv6_fwd", "wkv6_bwd")),
}
#: kernel module -> the TPU kernel its kernels replace (file:line)
REPLACES = {"flash_attention": "src/repro/kernels/flash_attention.py:35",
            "rglru": "src/repro/kernels/rglru.py:30",
            "wkv6": "src/repro/kernels/wkv6.py:40"}


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            print(f"== {name}", flush=True)
            out = fn(*a, **kw)
            print(f"== {name}: {time.perf_counter() - t0:.1f} s", flush=True)
            return out
        return run
    return wrap


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def make_inputs(B, S, H, K, hd, dtype, seed=0, **_):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(dtype)  # noqa: E731
    return mk(B, S, H, hd), mk(B, S, K, hd), mk(B, S, K, hd), mk(B, S, H, hd)


def close(got: torch.Tensor, want: torch.Tensor, rtol: float,
          atol_rms: float) -> tuple[float, float, float, float]:
    """(max abs error, rms(want), the least atol_rms that would pass with
    this rtol, the worst entry's error over its limit rtol * |want| +
    atol_rms * rms(want))."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rms = float(w.square().mean().sqrt())
    limit = (rtol * w.abs() + atol_rms * rms).clamp_min(1e-30)
    need = float((err - rtol * w.abs()).clamp_min(0).max()) / max(rms, 1e-30)
    return float(err.max()), rms, need, float((err / limit).max())


def report(label: str, name: str, got, want, rtol: float, atol: float) -> bool:
    """Print one comparison; True when every entry is finite and within
    its limit."""
    err, rms, need, ratio = close(got, want, rtol, atol)
    ok = bool(torch.isfinite(got).all()) and ratio <= 1.0
    print(f"  {label:15s} {name:15s} {str(got.dtype)[6:]:8s} max_abs_err "
          f"{err:.3e} rms {rms:.3e} atol needed {need:.2e} rms; "
          f"{ratio:.3f} of limit (rtol {rtol:.0e}, atol {atol:.0e} rms)"
          f"{'' if ok else '  FAIL'}", flush=True)
    return ok


# ----------------------------------------------------------------------
# 3. correctness against the plain versions
# ----------------------------------------------------------------------
@phase("kernels vs plain")
def check_kernels() -> dict:
    from repro_torch.kernels import flash_attention as fa

    worst: dict[str, float] = {}
    failed: list[str] = []
    for label, shp in CHECK_SHAPES:
        q, k, v, do = make_inputs(**shp)
        causal, window, dt = True, shp["window"], shp["dtype"]
        o, lse = fa.fwd(q, k, v, causal, window)
        delta = fa.bwd_delta(o, do)
        dq = fa.bwd_dq(q, k, v, do, lse, delta, causal, window)
        dk, dv = fa.bwd_dkdv(q, k, v, do, lse, delta, causal, window)
        torch.cuda.synchronize()
        p_o, p_lse = fa.plain_fwd(q, k, v, causal, window)
        p_delta = fa.plain_bwd_delta(o, do)
        # the backward kernels are held against the plain backward on the
        # same lse/delta, so each kernel is checked on its own inputs
        p_dq, p_dk, p_dv = fa.plain_bwd(q, k, v, do, lse, delta, causal, window)
        pairs = {"flash_fwd": [(o, p_o), (lse, p_lse)],
                 "flash_bwd_delta": [(delta, p_delta)],
                 "flash_bwd_dq": [(dq, p_dq)],
                 "flash_bwd_dkdv": [(dk, p_dk), (dv, p_dv)]}
        if label in ("slice", "l_block", "gqa_window", "f32_slice", "f32_l_block",
                     "f32_gqa_window"):
            pairs["autograd_vs_ref"] = list(zip(*autograd_vs_ref(q, k, v, do, window)))
        for name, items in pairs.items():
            for got, want in items:
                # lse and delta are float32 outputs of float32 math
                rtol, atol = AUTOGRAD_BF16_LIMIT if name == "autograd_vs_ref" and \
                    dt == torch.bfloat16 else LIMITS[got.dtype]
                if not report(label, name, got, want, rtol, atol):
                    failed.append(f"{name} at {label}")
                if label == "slice" and name in fa.LAUNCHES:
                    worst[name] = max(worst.get(name, 0.0),
                                      float((got.float() - want.float()).abs().max()))
        del q, k, v, do, o, lse, delta, dq, dk, dv, pairs
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"kernels disagree with their plain versions: {failed}")
    return worst


@phase("flash determinism")
def check_determinism() -> None:
    """``fwd``, then ``bwd_dq`` and ``bwd_dkdv`` on its lse, twice on the
    same inputs at the main paths' shapes: o, lse, dq, dk and dv must be
    bitwise equal (each output written by one thread, no atomics; the group
    partials are summed in a fixed order)."""
    from repro_torch.kernels import flash_attention as fa

    failed = []
    for label, shp in (("slice", SLICE), ("l_block", L_BLOCK)):
        q, k, v, do = make_inputs(**shp, seed=2)
        w = shp["window"]
        runs = []
        for _ in range(2):
            o, lse = fa.fwd(q, k, v, True, w)
            delta = fa.bwd_delta(o, do)
            runs.append((o, lse, fa.bwd_dq(q, k, v, do, lse, delta, True, w),
                         *fa.bwd_dkdv(q, k, v, do, lse, delta, True, w)))
        same = {name: torch.equal(a, b)
                for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), *runs)}
        print(f"  {label:15s} bitwise equal over two runs: {same}", flush=True)
        if not all(same.values()):
            failed.append(label)
        del q, k, v, do, o, lse, delta, runs
    if failed:
        raise SystemExit(f"the flash kernels are not deterministic at {failed}")


def _kernel_label(mangled: str) -> str:
    """flash_bwd_dq_mma_kernel<bf16,128,4,64> from a mangled name (the
    tensor-core kernels take bfloat16, the others float32)."""
    name = re.search(r"flash_(?:fwd|bwd)\w*?_kernel", mangled).group()
    dtype = "bf16" if "_mma_" in name else "f32"
    args = [dtype, *re.findall(r"Li(\d+)E", mangled)]
    return f"{name}<{','.join(args)}>"


#: the flash kernels whose build is reported (forward, dq, dk/dv; not delta)
_REPORTED = re.compile(r"flash_(?:fwd|bwd_d(?:q|kdv))")


@phase("flash build")
def report_flash_build() -> None:
    """For every flash forward and backward kernel: its ``-Xptxas -v``
    lines from the build log (registers, spills), the CUDA runtime's
    registers, dynamic shared memory and CTAs per SM of each bfloat16
    tensor-core instantiation, and the HMMA instructions in its SASS
    (``cuobjdump -sass``).  Fails if a tensor-core kernel spills or has no
    HMMA."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.build import library_path

    lib = library_path(fa.SOURCE)
    failed, cur, info = [], None, {}
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1) if _REPORTED.search(m.group(1)) else None
        elif cur and ("spill" in line or "Used" in line):
            info.setdefault(_kernel_label(cur), []).append(line.strip())
    for label, lines in sorted(info.items()):
        print(f"  ptxas {label}: {' | '.join(lines)}", flush=True)
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill", " ".join(lines))]
        if "_mma_" in label and any(spills):
            failed.append(f"{label} spills")
    for kernel in fa.MMA_KERNELS:
        for hd in fa.SUPPORTED_HEAD_DIMS:
            print(f"  runtime {kernel} bf16 hd {hd}: {fa.occupancy(kernel, hd)}", flush=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("  cuobjdump not found: HMMA not counted", flush=True)
    else:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              check=True).stdout
        counts, cur = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\w+)", line)
            if m:
                cur = _kernel_label(m.group(1)) if _REPORTED.search(m.group(1)) else None
                if cur:
                    counts[cur] = 0
            elif cur and "HMMA" in line:
                counts[cur] += 1
        for label, n in sorted(counts.items()):
            print(f"  sass {label}: {n} HMMA", flush=True)
            if "_mma_" in label and n == 0:
                failed.append(f"{label} has no HMMA")
        failed += [f"{kernel}_mma_kernel at hd {hd} not in the SASS"
                   for kernel in fa.MMA_KERNELS for hd in fa.SUPPORTED_HEAD_DIMS
                   if not any(label.startswith(f"{kernel}_mma_kernel<bf16,{hd},")
                              for label in counts)]
    if failed:
        raise SystemExit(f"flash build: {failed}")


def autograd_vs_ref(q, k, v, do, window):
    """(output, dq, dk, dv) through the kernels' autograd.Function and
    through autograd of the plain ``ref.attention`` (the independent oracle
    of the CPU tests) in float32 on the same values."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    got, want = [], []
    for fn, out, ins in ((fa.flash_attention, got, (q, k, v, do)),
                         (ref.attention, want, [t.float() for t in (q, k, v, do)])):
        leaves = [t.detach().requires_grad_() for t in ins[:3]]
        o = fn(*leaves, causal=True, window=window)
        out.extend([o.detach(), *torch.autograd.grad(o, leaves, ins[3])])
    return got, want


def rglru_inputs(B, S, W, dtype, h0=False, r_shift=0.0, seed=0, **_):
    """x, r, i, dout (B, S, W) in ``dtype``; lam = linspace(0.1, 2, W) as
    the model's init; h0 and dh_last (B, W) f32 (h0 None unless asked)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, r, i, dout = (torch.randn(B, S, W, generator=g, device="cuda") for _ in range(4))
    lam = torch.linspace(0.1, 2.0, W, device="cuda")
    h_0 = torch.randn(B, W, generator=g, device="cuda") if h0 else None
    dh_last = torch.randn(B, W, generator=g, device="cuda")
    return (x.to(dtype), (r + r_shift).to(dtype), i.to(dtype), lam, h_0, dout.to(dtype),
            dh_last)


@phase("rglru kernels vs plain")
def check_rglru() -> dict:
    """``rglru_fwd`` (out, h_last, the f32 states) against the plain
    forward, and ``rglru_bwd`` (dx, dr, di, dlam, dh0) against autograd
    through ``ref.rglru`` on the same inputs, element by element with
    ``LIMITS`` by each output's dtype (the scan is float32 math on both
    sides; bf16 outputs round once)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru as rg

    worst: dict[str, float] = {}
    failed: list[str] = []
    for label, shp in RGLRU_SHAPES:
        x, r, i, lam, h0, dout, dh_last = rglru_inputs(**shp)
        out, h_last, states = rg.fwd(x, r, i, lam, h0, save_states=True)
        got_bwd = rg.bwd(x, r, i, lam, h0, states, dout, dh_last)
        torch.cuda.synchronize()
        p_out, p_h, p_states = rg.plain_fwd(x, r, i, lam, h0, save_states=True)
        leaves = [t.detach().requires_grad_() for t in (x, r, i, lam)]
        if h0 is not None:
            leaves.append(h0.detach().requires_grad_())
        o, h = ref.rglru(*leaves[:4], leaves[4] if h0 is not None else None)
        want_bwd = torch.autograd.grad((o, h), leaves, (dout, dh_last))
        pairs = {"rglru_fwd": [(out, p_out), (h_last, p_h), (states, p_states)],
                 "rglru_bwd": list(zip(got_bwd, want_bwd))}
        for name, items in pairs.items():
            for got, want in items:
                if not report(label, name, got, want, *LIMITS[got.dtype]):
                    failed.append(f"{name} at {label}")
                if label == "slice":
                    worst[name] = max(worst.get(name, 0.0),
                                      float((got.float() - want.float()).abs().max()))
        del x, r, i, dout, out, states, got_bwd, p_out, p_states, leaves, o, want_bwd, pairs
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"RG-LRU kernels disagree with their plain versions: {failed}")
    return worst


def wkv6_inputs(B, S, H, hd, dtype, state=False, decay="mild", seed=0, **_):
    """r, k (0.5 N(0, 1)), v, w, dout (B, S, H, hd) in ``dtype``; u (H, hd)
    0.3 N(0, 1) f32; the state (B, H, hd, hd) f32 (None unless asked) and
    a final-state cotangent ds_last (B, H, hd, hd) f32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    r, k, v, dout = 0.5 * mk(B, S, H, hd), 0.5 * mk(B, S, H, hd), mk(B, S, H, hd), \
        mk(B, S, H, hd)
    if decay == "strong":
        w = 1e-3 + (0.2 - 1e-3) * torch.rand(B, S, H, hd, generator=g, device="cuda")
    else:
        w = torch.exp(-torch.exp(mk(B, S, H, hd) - (12.0 if decay == "one" else 3.0)))
    u = 0.3 * mk(H, hd)
    st = mk(B, H, hd, hd) if state else None
    ds_last = mk(B, H, hd, hd)
    r, k, v, w, dout = (t.to(dtype) for t in (r, k, v, w, dout))
    if decay == "one" and not bool((w == 1.0).all()):
        raise SystemExit("the w = 1 shape does not round w to 1.0")
    return r, k, v, w, u, st, dout, ds_last


@phase("wkv6 kernels vs plain")
def check_wkv6() -> dict:
    """``wkv6_fwd`` (out, s_last, the f32 checkpoints) against the plain
    forward, and ``wkv6_bwd`` (dr, dk, dv, dw, du, ds0) against autograd
    through ``ref.wkv6`` on the same inputs, element by element with
    ``LIMITS`` by each output's dtype (float32 math on both sides; bf16
    outputs round once)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wk

    worst: dict[str, float] = {}
    failed: list[str] = []
    for label, shp in WKV6_SHAPES:
        r, k, v, w, u, st, dout, ds_last = wkv6_inputs(**shp)
        out, s_last, ckpt = wk.fwd(r, k, v, w, u, st, save_ckpt=True)
        got_bwd = wk.bwd(r, k, v, w, u, ckpt, dout, ds_last)
        torch.cuda.synchronize()
        p_out, p_s, p_ckpt = wk.plain_fwd(r, k, v, w, u, st, save_ckpt=True)
        leaves = [t.detach().requires_grad_() for t in (r, k, v, w, u)]
        if st is not None:
            leaves.append(st.detach().requires_grad_())
        o, s = ref.wkv6(*leaves[:5], state=leaves[5] if st is not None else None)
        want_bwd = torch.autograd.grad((o, s), leaves, (dout, ds_last))
        del o, s
        pairs = {"wkv6_fwd": [(out, p_out), (s_last, p_s), (ckpt, p_ckpt)],
                 "wkv6_bwd": list(zip(got_bwd, want_bwd))}
        for name, items in pairs.items():
            for got, want in items:
                if not report(label, name, got, want, *LIMITS[got.dtype]):
                    failed.append(f"{name} at {label}")
                if label == "slice":
                    worst[name] = max(worst.get(name, 0.0),
                                      float((got.float() - want.float()).abs().max()))
        del r, k, v, w, dout, out, ckpt, got_bwd, p_out, p_ckpt, leaves, want_bwd, pairs
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"wkv6 kernels disagree with their plain versions: {failed}")
    return worst


#: reduced models of the model check: arch -> (depth, kernel -> launches
#: per unit in one forward)
MODEL_CHECKS = {"qwen1.5-4b": (2, {"flash_fwd": 1}),
                "recurrentgemma-2b": (3, {"flash_fwd": 1, "rglru_fwd": 2}),
                "rwkv6-1.6b": (2, {"wkv6_fwd": 1})}


@phase("model on the card vs the CPU")
def check_model() -> None:
    """Reduced qwen1.5-4b (float32, 2 layers, head dim 64), reduced
    recurrentgemma-2b (float32, RRL, rnn width 256, window 64 under 256
    tokens) and reduced rwkv6-1.6b (float32, 2 W layers, 4 wkv heads of
    64): loss and every gradient leaf through the kernels on the card
    against the plain versions on the CPU, from the same parameters and
    batch.  Tolerance 1e-4 of each leaf's scale: both sides are float32
    (TF32 off), summed in different orders."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    failed = []
    for arch, (depth, per_unit) in MODEL_CHECKS.items():
        cfg = get_config(arch).reduced(num_layers=depth)
        g = torch.Generator().manual_seed(0)
        tokens, labels = (torch.randint(0, cfg.vocab_size, (2, 256), generator=g)
                          for _ in range(2))
        params = T.init_lm(cfg, seed=0)
        results = []
        for dev in ("cpu", "cuda"):
            p = T.map_leaves(lambda _, t: t.to(dev).requires_grad_(), params)
            leaves = [t for _, t in T.leaf_order(p)]
            before = kernels.all_launches()
            loss = T.loss_fn(cfg, p, tokens.to(dev), labels.to(dev))[0]
            launched = {k: n - before[k] for k, n in kernels.all_launches().items()}
            grads = torch.autograd.grad(loss, leaves)
            results.append((float(loss.detach()), [gr.cpu() for gr in grads]))
            want = {k: n * cfg.num_units for k, n in per_unit.items()}
            if dev == "cuda" and any(launched[k] != n for k, n in want.items()):
                raise SystemExit(f"{arch} on the card: forward launches {launched}, "
                                 f"want {want}")
        (l_cpu, g_cpu), (l_gpu, g_gpu) = results
        worst, leaf = max((float((a - b).abs().max()) / max(float(a.abs().max()), 1e-6),
                           "/".join(path))
                          for (path, _), a, b in zip(T.leaf_order(params), g_cpu, g_gpu))
        print(f"  {arch}: loss cpu {l_cpu:.6f} card {l_gpu:.6f}; worst gradient leaf "
              f"{leaf} error {worst:.3e} of its scale (tol 1e-4)", flush=True)
        if not (math.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)) \
                or worst > 1e-4:
            failed.append(arch)
    if failed:
        raise SystemExit(f"model on the card disagrees with the CPU: {failed}")


# ----------------------------------------------------------------------
# 4. timing at the slice shape
# ----------------------------------------------------------------------
#: GPU cycles (~2 ms) the stream sleeps before a timed run, so that the
#: host has queued the launches ahead of the device: a kernel shorter than
#: its wrapper's host time is timed on the device, not on the host.
QUEUE_AHEAD_CYCLES = 4_000_000


def time_ms(fn, iters=20) -> float:
    """Mean device time of one call of ``fn``, with the 50 MB L2 refilled
    before each call by reading 64 MB (a read leaves no dirty lines to
    write back during the timed call) and only the calls timed: the time
    of a call whose inputs come from device memory, not from L2, as on the
    main path, where a layer's activations do not stay in L2 between its
    forward and its backward."""
    flush = torch.ones(16 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


def bounds(B, S, H, K, hd, window, dtype, **_) -> dict:
    """Least time per kernel at this shape: max(bytes / HBM rate, FLOPs /
    peak rate for the input type).  FLOPs count only the matrix products
    over the (query, key) pairs the mask lets through (exp and the
    elementwise work are left out); bytes count each input read once and
    each output written once."""
    pos = torch.arange(S)
    vis = pos[None, :] <= pos[:, None]
    if window is not None:
        vis &= pos[None, :] > pos[:, None] - window
    pairs = float(vis.sum()) * B * H
    es = torch.finfo(dtype).bits // 8
    qb, kb, stat = B * S * H * hd * es, B * S * K * hd * es, B * H * S * 4
    work = {  # name: (matmul FLOPs, bytes)
        "flash_fwd": (4 * pairs * hd, qb + 2 * kb + qb + stat),
        "flash_bwd_delta": (2 * B * S * H * hd, 2 * qb + stat),
        "flash_bwd_dq": (6 * pairs * hd, 2 * qb + 2 * kb + 2 * stat + qb),
        "flash_bwd_dkdv": (8 * pairs * hd, 2 * qb + 2 * kb + 2 * stat + 2 * kb),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes")
    return out


def rglru_bounds(B, S, W, dtype, **_) -> dict:
    """Least time per RG-LRU kernel at this shape, as on the main path (no
    h0; the forward saves the f32 states; autograd hands the backward a
    zero dh_last): bytes count each input read once and each output
    written once; operations are the scan's float32 arithmetic per element
    and step (21 forward, 38 backward, counted from the kernels) at the
    CUDA cores' float32 rate."""
    n, es = B * S * W, torch.finfo(dtype).bits // 8
    work = {  # name: (float32 operations, bytes)
        "rglru_fwd": (21 * n, 3 * n * es + W * 4 + n * es + B * W * 4 + n * 4),
        "rglru_bwd": (38 * n, 4 * n * es + W * 4 + n * 4 + B * W * 4 + 3 * n * es + W * 4
                      + B * W * 4),
    }
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes")
    return out


def wkv6_bounds(B, S, H, hd, dtype, **_) -> dict:
    """Least time per wkv6 kernel at this shape, as on the main path (no
    initial state; the forward saves the checkpoints; autograd hands the
    backward a zero final-state cotangent): bytes count each input read
    once and each output written once; operations are the float32
    arithmetic the function needs, at the CUDA cores' float32 rate.
    Forward: 5 per state entry and step (the r^T S FMA, the decay multiply,
    the k v FMA) plus 5 per channel and step for the u bonus, taken as
    (r . (u * k)) v_t. Backward: 14 per state entry and step (dr, dk and dw
    FMAs, the dv product and its sum, the cotangent update, and rebuilding
    S_{t-1} once)."""
    from repro_torch.kernels.wkv6 import num_checkpoints

    n, es = B * S * H * hd, torch.finfo(dtype).bits // 8
    state, u = B * H * hd * hd * 4, H * hd * 4
    ckpt, entries = num_checkpoints(S) * state, B * H * S * hd * hd
    work = {  # name: (float32 operations, bytes)
        "wkv6_fwd": (5 * entries + 5 * n, 4 * n * es + u + n * es + state + ckpt),
        "wkv6_bwd": (14 * entries, 5 * n * es + u + ckpt + state + 4 * n * es + u + state),
    }
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes")
    return out


def library_times(q, k, v, o, do) -> dict:
    """scaled_dot_product_attention forward, its flash backward (one call
    giving dq, dk, dv), and ``torch.linalg.vecdot`` for delta (rowsum(dO *
    O), (B, S, H) in bf16 where the kernel writes (B, H, S) in f32), on the
    same inputs; (B, H, S, hd) views for SDPA, with k and v expanded to the
    H query heads beforehand where K < H (the library's flash kernels take
    equal head counts)."""
    import torch.nn.functional as F

    from repro_torch.kernels.ref import repeat_kv

    H, K = q.shape[2], k.shape[2]
    k, v = repeat_kv(k, H // K).contiguous(), repeat_kv(v, H // K).contiguous()
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    out = {"flash_fwd": time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)),
           "flash_bwd_delta": time_ms(lambda: torch.linalg.vecdot(o, do, dim=-1))}
    try:
        o, lse, cq, ck, mq, mk, seed, off, _ = \
            torch.ops.aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, True)
        bwd = lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(  # noqa: E731
            dot, qt, kt, vt, o, lse, cq, ck, mq, mk, 0.0, True, seed, off)
        out["flash_bwd_dq"] = out["flash_bwd_dkdv"] = time_ms(bwd)
    except (RuntimeError, TypeError) as e:   # library op missing or refusing
        print(f"  library backward not timed: {e}", flush=True)
    return out


def print_row(label: str, name: str, row: dict) -> None:
    print(f"  {label:8s} {name:16s} " + " ".join(
        f"{key} {val:.4f}" if isinstance(val, float) else f"{key} {val}"
        for key, val in row.items()), flush=True)


def time_flash(shp: dict, label: str) -> dict:
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = make_inputs(**shp, seed=1)
    w = shp["window"]
    o, lse = fa.fwd(q, k, v, True, w)
    delta = fa.bwd_delta(o, do)
    runs = {
        "flash_fwd": (lambda: fa.fwd(q, k, v, True, w), lambda: fa.plain_fwd(q, k, v, True, w)),
        "flash_bwd_delta": (lambda: fa.bwd_delta(o, do), lambda: fa.plain_bwd_delta(o, do)),
        "flash_bwd_dq": (lambda: fa.bwd_dq(q, k, v, do, lse, delta, True, w),
                         lambda: fa.plain_bwd(q, k, v, do, lse, delta, True, w)),
        "flash_bwd_dkdv": (lambda: fa.bwd_dkdv(q, k, v, do, lse, delta, True, w),
                           lambda: fa.plain_bwd(q, k, v, do, lse, delta, True, w)),
    }
    bnd = bounds(**shp)
    lib = library_times(q, k, v, o, do)
    out = {}
    for name, (kern, plain) in runs.items():
        out[name] = {"ms": time_ms(kern), "plain_ms": time_ms(plain, iters=5),
                     "bound_ms": bnd[name][0], "bound_by": bnd[name][1],
                     "library_ms": lib.get(name)}
        print_row(label, name, out[name])
    pair = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkdv"]["ms"]
    lib_bwd = out["flash_bwd_dq"]["library_ms"]
    print(f"  {label:8s} backward pair (dq + dk/dv) {pair:.4f} ms; library backward "
          f"{'not timed' if lib_bwd is None else f'{lib_bwd:.4f} ms'}", flush=True)
    del q, k, v, do, o, lse, delta, runs
    torch.cuda.empty_cache()
    return out


def time_rglru(shp: dict, label: str) -> dict:
    """No single PyTorch call computes a gated linear recurrence, so there
    is no library time."""
    from repro_torch.kernels import rglru as rg

    x, r, i, lam, _, dout, dh_last = rglru_inputs(**shp, seed=1)
    _, _, states = rg.fwd(x, r, i, lam, None, save_states=True)
    dh_last = torch.zeros_like(dh_last)
    runs = {
        "rglru_fwd": (lambda: rg.fwd(x, r, i, lam, None, save_states=True),
                      lambda: rg.plain_fwd(x, r, i, lam, None, save_states=True)),
        "rglru_bwd": (lambda: rg.bwd(x, r, i, lam, None, states, dout, dh_last),
                      lambda: rg.plain_bwd(x, r, i, lam, None, states, dout, dh_last)),
    }
    bnd = rglru_bounds(**shp)
    out = {}
    for name, (kern, plain) in runs.items():
        out[name] = {"ms": time_ms(kern), "plain_ms": time_ms(plain, iters=3),
                     "bound_ms": bnd[name][0], "bound_by": bnd[name][1], "library_ms": None}
        print_row(label, name, out[name])
    return out


def time_wkv6(shp: dict, label: str) -> dict:
    """No single PyTorch call computes the wkv scan, so there is no library
    time."""
    from repro_torch.kernels import wkv6 as wk

    r, k, v, w, u, _, dout, ds_last = wkv6_inputs(**shp, seed=1)
    _, _, ckpt = wk.fwd(r, k, v, w, u, None, save_ckpt=True)
    ds_last = torch.zeros_like(ds_last)
    runs = {
        "wkv6_fwd": (lambda: wk.fwd(r, k, v, w, u, None, save_ckpt=True),
                     lambda: wk.plain_fwd(r, k, v, w, u, None, save_ckpt=True)),
        "wkv6_bwd": (lambda: wk.bwd(r, k, v, w, u, ckpt, dout, ds_last),
                     lambda: wk.plain_bwd(r, k, v, w, u, ckpt, dout, ds_last)),
    }
    bnd = wkv6_bounds(**shp)
    out = {}
    for name, (kern, plain) in runs.items():
        out[name] = {"ms": time_ms(kern), "plain_ms": time_ms(plain, iters=3),
                     "bound_ms": bnd[name][0], "bound_by": bnd[name][1], "library_ms": None}
        print_row(label, name, out[name])
    return out


@phase("timing")
def time_kernels() -> dict:
    """Each kernel at its main path's shape (the kernels line); the flash
    kernels also at recurrentgemma-2b's local-attention shape (printed
    rows of their own)."""
    timing = {**time_flash(SLICE, "slice"), **time_rglru(RGLRU_SLICE, "slice"),
              **time_wkv6(WKV6_SLICE, "slice")}
    time_flash(L_BLOCK, "l_block")
    return timing


# ----------------------------------------------------------------------
# 5-6. the main path: the measurement loop through the kernels
# ----------------------------------------------------------------------
def run_measure(arch: str, args: list[str]) -> dict:
    from repro_torch import kernels
    from repro_torch.measure.run import main as measure_main

    @phase(f"measure {arch}")
    def run() -> dict:
        with tempfile.TemporaryDirectory() as tmp:
            kernels.reset_launches()
            rc = measure_main(args + ["--out-dir", tmp])
            if rc != 0:
                raise SystemExit(f"repro_torch.measure exited {rc}")
            doc = json.loads((Path(tmp) / f"{arch}.json").read_text())
            trace_text = (Path(tmp) / f"{arch}.trace").read_text()
        check_measurement(doc, trace_text)
        return doc

    return run()


def check_measurement(doc: dict, trace_text: str) -> None:
    """The repository's own checks on a measured run: finite positive
    times, the trace's layer rows, the counted all-reduce bytes equal to
    the payload accounting for every policy."""
    for pol, t in doc["policy_times_s"].items():
        if not (math.isfinite(t) and t > 0):
            raise SystemExit(f"policy {pol}: bad step time {t}")
    # the same init and batch under each policy: the losses after the timed
    # steps differ only by the policies' rounding (bf16 vs f32 sums)
    losses = list(doc["policy_losses"].values())
    if not all(math.isfinite(x) for x in losses) or max(losses) - min(losses) > 1e-2 * max(losses):
        raise SystemExit(f"policy losses disagree: {doc['policy_losses']}")
    # at lr 1e-2 the bf16 weights barely move, so the loss says little of the
    # sync; the momentum sums the synchronized gradients of every step
    norms = doc["policy_momentum_norms"]
    worst_leaf, worst = "", 0.0
    for leaf in next(iter(norms.values())):
        vals = [norms[pol][leaf] for pol in norms]
        if not all(math.isfinite(x) and x > 0 for x in vals):
            raise SystemExit(f"momentum of {leaf}: {vals}")
        if (max(vals) - min(vals)) / max(vals) >= worst:
            worst_leaf, worst = leaf, (max(vals) - min(vals)) / max(vals)
    print(f"  momentum norms: worst leaf {worst_leaf} differs by {worst:.3e} across "
          f"policies (limit {MOMENTUM_RTOL:.0e})", flush=True)
    if worst > MOMENTUM_RTOL:
        raise SystemExit(f"policies disagree on the momentum of {worst_leaf}: "
                         f"{ {pol: norms[pol][worst_leaf] for pol in norms} }")
    if not (math.isfinite(doc["t_update_s"]) and doc["t_update_s"] > 0):
        raise SystemExit("bad t_update_s")
    for pol, chk in doc["bytes_crosscheck"].items():
        if chk["counted_bytes"] != chk["expected_bytes"]:
            raise SystemExit(f"{pol}: counted {chk['counted_bytes']} all-reduce bytes, "
                             f"expected {chk['expected_bytes']}")
    rows = [ln.split("\t") for ln in trace_text.splitlines()
            if ln and not ln.startswith("#")]
    if len(rows) != 1 + doc["num_units"] or rows[0][1] != "embed_head":
        raise SystemExit(f"trace rows {[r[1] for r in rows]}")
    for r in rows:
        vals = [float(x) for x in r[2:6]]
        if not all(math.isfinite(x) and x >= 0 for x in vals) or vals[3] <= 0:
            raise SystemExit(f"bad trace row {r}")
    brief = {k: doc[k] for k in ("policy_times_s", "policy_losses", "segments", "t_update_s",
                                 "allreduce_fit", "bytes_crosscheck", "kernel_launches",
                                 "peak_memory_bytes", "elapsed_s")}
    print(json.dumps(brief, indent=1), flush=True)


def main() -> int:
    # the port first: without it (the script alone) nothing is printed
    from repro_torch import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)

    phase("build kernels")(kernels.load_libraries)()
    report_flash_build()
    worst = {**check_kernels(), **check_rglru(), **check_wkv6()}
    check_model()
    check_determinism()
    timing = time_kernels()

    launches: dict[str, int] = {}
    for arch, (args, must) in MAIN_PATHS.items():
        counts = run_measure(arch, args)["kernel_launches"]
        print(f"  {arch}: launches {counts}", flush=True)
        missing = [name for name in must if counts.get(name, 0) <= 0]
        if missing:
            raise SystemExit(f"kernels not launched on the {arch} path: {missing}")
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    line = [{"name": name, "route": "cuda", "source": str(mod.SOURCE.relative_to(ROOT)),
             "replaces": REPLACES[mod.__name__.rsplit(".", 1)[1]], "launches": launches[name],
             "max_abs_err": worst[name], **timing[name]}
            for mod in kernels.kernel_modules() for name in mod.LAUNCHES]
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
