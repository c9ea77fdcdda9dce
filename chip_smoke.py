"""Drives the port on one NVIDIA H100: ``python3 chip_smoke.py``.

Phases, in order; any failure ends the script with a non-zero code:

1. print the card's name and power limit (``nvidia-smi``);
2. build the flash-attention kernels from ``src/repro_torch/csrc``;
3. hold every kernel (forward, delta, dq, dk/dv) against its plain
   PyTorch version on the card, element by element, at the slice's shape
   and at a GQA + window (hd 256) shape in bfloat16 and in float32, and at
   a ragged and two more float32 shapes; hold the differentiable
   attention against autograd through ``ref.attention``; hold a reduced
   qwen1.5-4b's loss and gradients on the card (through the kernels)
   against the same model on the CPU (plain versions);
4. time each kernel, its plain version, its bound and the PyTorch library
   call that computes the same function (``scaled_dot_product_attention``
   and its backward, timed here only and never called by the port);
5. run ``repro_torch.measure`` for qwen1.5-4b at its published widths
   (depth cut to 2 units) with 2 gloo ranks on the card and all three sync
   policies, check the written trace, the counted all-reduce bytes and
   that the three policies leave the same momentum;
6. check that every kernel's launch counter rose during that run;
7. print the ``kernels`` line, then the ``ok`` line last.

It imports nothing of JAX and nothing of the reference package ``repro``.
"""
from __future__ import annotations

import json
import math
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

# The slice's attention shape: qwen1.5-4b at batch_per_gpu 2, seq 1024.
SLICE = dict(B=2, S=1024, H=20, K=20, hd=128, window=None, dtype=torch.bfloat16)
CHECK_SHAPES = [
    ("slice", SLICE),
    ("gqa_window", dict(B=1, S=2048, H=4, K=1, hd=256, window=512, dtype=torch.bfloat16)),
    ("ragged", dict(B=2, S=1000, H=8, K=4, hd=128, window=None, dtype=torch.bfloat16)),
    ("f32_slice", dict(SLICE, dtype=torch.float32)),
    ("f32_gqa_window", dict(B=1, S=2048, H=4, K=1, hd=256, window=512, dtype=torch.float32)),
    ("f32_hd64", dict(B=2, S=512, H=4, K=2, hd=64, window=100, dtype=torch.float32)),
    ("f32_hd32_ragged", dict(B=1, S=300, H=2, K=1, hd=32, window=32, dtype=torch.float32)),
]
MEASURE_ARGS = ["--arch", "qwen1.5-4b", "--seq-len", "1024", "--batch-per-gpu", "2",
                "--num-layers", "2", "--devices", "2", "--repeats", "3",
                "--step-iters", "3"]


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
        if label in ("slice", "gqa_window", "f32_slice", "f32_gqa_window"):
            pairs["autograd_vs_ref"] = list(zip(*autograd_vs_ref(q, k, v, do, window)))
        for name, items in pairs.items():
            for got, want in items:
                # lse and delta are float32 outputs of float32 math
                rtol, atol = AUTOGRAD_BF16_LIMIT if name == "autograd_vs_ref" and \
                    dt == torch.bfloat16 else LIMITS[got.dtype]
                err, rms, need, ratio = close(got, want, rtol, atol)
                ok = bool(torch.isfinite(got).all()) and ratio <= 1.0
                print(f"  {label:15s} {name:15s} {str(got.dtype)[6:]:8s} max_abs_err "
                      f"{err:.3e} rms {rms:.3e} atol needed {need:.2e} rms; "
                      f"{ratio:.3f} of limit (rtol {rtol:.0e}, atol {atol:.0e} rms)"
                      f"{'' if ok else '  FAIL'}", flush=True)
                if not ok:
                    failed.append(f"{name} at {label}")
                if label == "slice" and name in fa.LAUNCHES:
                    worst[name] = max(worst.get(name, 0.0), err)
        del q, k, v, do, o, lse, delta, dq, dk, dv, pairs
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"kernels disagree with their plain versions: {failed}")
    return worst


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


@phase("model on the card vs the CPU")
def check_model() -> None:
    """Reduced qwen1.5-4b (float32, 2 layers, head dim 64): loss and every
    gradient leaf through the kernels on the card against the plain
    versions on the CPU, from the same parameters and batch.  Tolerance
    1e-4 of each leaf's scale: both sides are float32 (TF32 off), summed
    in different orders."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen1.5-4b").reduced(num_layers=2)
    g = torch.Generator().manual_seed(0)
    tokens, labels = (torch.randint(0, cfg.vocab_size, (2, 256), generator=g)
                      for _ in range(2))
    params = T.init_lm(cfg, seed=0)
    results = []
    for dev in ("cpu", "cuda"):
        p = T.map_leaves(lambda _, t: t.to(dev).requires_grad_(), params)
        leaves = [t for _, t in T.leaf_order(p)]
        before = fa.LAUNCHES["flash_fwd"]
        loss = T.loss_fn(cfg, p, tokens.to(dev), labels.to(dev))[0]
        grads = torch.autograd.grad(loss, leaves)
        results.append((float(loss.detach()), [gr.cpu() for gr in grads]))
        if dev == "cuda" and fa.LAUNCHES["flash_fwd"] - before != cfg.num_units:
            raise SystemExit("the model on the card did not go through flash_fwd")
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results
    worst = max(float((a - b).abs().max()) / max(float(a.abs().max()), 1e-6)
                for a, b in zip(g_cpu, g_gpu))
    print(f"  loss cpu {l_cpu:.6f} card {l_gpu:.6f}; worst gradient leaf "
          f"error {worst:.3e} of its scale (tol 1e-4)", flush=True)
    if not (math.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)) \
            or worst > 1e-4:
        raise SystemExit("model on the card disagrees with the CPU")


# ----------------------------------------------------------------------
# 4. timing at the slice shape
# ----------------------------------------------------------------------
def time_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def library_times(q, k, v, o, do) -> dict:
    """scaled_dot_product_attention forward, its flash backward (one call
    giving dq, dk, dv), and ``torch.linalg.vecdot`` for delta (rowsum(dO *
    O), (B, S, H) in bf16 where the kernel writes (B, H, S) in f32), on the
    slice's inputs; (B, H, S, hd) views for SDPA."""
    import torch.nn.functional as F

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


@phase("timing")
def time_kernels() -> dict:
    from repro_torch.kernels import flash_attention as fa

    shp = SLICE
    q, k, v, do = make_inputs(**shp, seed=1)
    o, lse = fa.fwd(q, k, v)
    delta = fa.bwd_delta(o, do)
    runs = {
        "flash_fwd": (lambda: fa.fwd(q, k, v), lambda: fa.plain_fwd(q, k, v)),
        "flash_bwd_delta": (lambda: fa.bwd_delta(o, do), lambda: fa.plain_bwd_delta(o, do)),
        "flash_bwd_dq": (lambda: fa.bwd_dq(q, k, v, do, lse, delta),
                         lambda: fa.plain_bwd(q, k, v, do, lse, delta)),
        "flash_bwd_dkdv": (lambda: fa.bwd_dkdv(q, k, v, do, lse, delta),
                           lambda: fa.plain_bwd(q, k, v, do, lse, delta)),
    }
    bnd = bounds(**shp)
    lib = library_times(q, k, v, o, do)
    out = {}
    for name, (kern, plain) in runs.items():
        out[name] = {"ms": time_ms(kern), "plain_ms": time_ms(plain, iters=5),
                     "bound_ms": bnd[name][0], "bound_by": bnd[name][1],
                     "library_ms": lib.get(name)}
        print(f"  {name:16s} " + " ".join(
            f"{key} {val:.4f}" if isinstance(val, float) else f"{key} {val}"
            for key, val in out[name].items()), flush=True)
    return out


# ----------------------------------------------------------------------
# 5-6. the main path: the measurement loop through the kernels
# ----------------------------------------------------------------------
@phase("measure qwen1.5-4b")
def run_measure() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.measure.run import main as measure_main

    with tempfile.TemporaryDirectory() as tmp:
        fa.reset_launches()
        rc = measure_main(MEASURE_ARGS + ["--out-dir", tmp])
        if rc != 0:
            raise SystemExit(f"repro_torch.measure exited {rc}")
        doc = json.loads((Path(tmp) / "qwen1.5-4b.json").read_text())
        trace_text = (Path(tmp) / "qwen1.5-4b.trace").read_text()
    check_measurement(doc, trace_text)
    return doc


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
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)

    phase("build kernels")(fa.load_library)()
    worst = check_kernels()
    check_model()
    timing = time_kernels()
    doc = run_measure()

    launches = doc["kernel_launches"]
    missing = [name for name in fa.LAUNCHES if launches.get(name, 0) <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the main path: {missing}")
    replaces = "src/repro/kernels/flash_attention.py:35"
    kernels = [{"name": name, "route": "cuda",
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": worst[name], **timing[name]} for name in fa.LAUNCHES]
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
