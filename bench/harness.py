"""One run of one cell: set-up, the measured window, the traced steps, and
the comparison that decides ``correct``.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
names a configuration (``bench/configs/<config>.json``, whose ``family``
names the reference ``bench/reference/<family>.py``) and a traffic mix
(``bench/traffic/<traffic>.json``); its limits are
``bench/limits/<cell>.json``; each metric it reports is read by
``bench/metrics/<metric>.py`` from the run's record.

The window drives the program's data-parallel S-SGD step at world 1
(``repro_torch.comm.ddp.make_ddp_train_step`` with ``sync_policy="none"``),
fed by ``repro_torch.data.pipeline.PrefetchLoader`` over batches made from
the seed, reading the loss every step.  Set-up makes the parameters on the
device from the seed, builds the step and its optimizer state once, and
drives that same step through the mix's first ``check_steps`` steps, whose
readings the reference follows after the window."""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

from bench import check
from bench.weights import batches, draw, nest

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ----------------------------------------------------------------------
# Finding a cell's pieces by name
# ----------------------------------------------------------------------
def load_spec(cell: str, root: Path = ROOT) -> dict:
    """The cell's workload entry, configuration, traffic mix, limits and the
    metrics it reports (end-to-end with ``--trace 0``, per-layer with 1)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    w = work[cell]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    e2e_names = {m["name"] for m in e2e}

    def reported(m):
        return cell in m["workloads"] if "workloads" in m else m["moves"] in e2e_names

    layer = [m for m in bench["per_layer"] if reported(m)]
    return {"cell": cell, "workload": w,
            "config": json.loads((root / conf["file"]).read_text()),
            "traffic": json.loads((root / "bench" / "traffic" / f"{w['traffic']}.json")
                                  .read_text()),
            "limits": json.loads((root / "bench" / "limits" / f"{cell}.json").read_text()),
            "end_to_end": e2e, "per_layer": layer}


def family(config: dict):
    return importlib.import_module(f"bench.reference.{config['family']}")


def reader(metric: str, root: Path = ROOT):
    """``read(record) -> float | None`` of ``bench/metrics/<metric>.py``."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ----------------------------------------------------------------------
# The program
# ----------------------------------------------------------------------
def program_config(c: dict):
    """The program's ``ModelConfig`` from the configuration file's keys."""
    import dataclasses

    from repro_torch.models.common import ModelConfig

    keys = {f.name for f in dataclasses.fields(ModelConfig)}
    fields = {k: v for k, v in c.items() if k in keys}
    fields["dtype"] = getattr(torch, c["dtype"])
    fields["logit_dtype"] = torch.float32
    return ModelConfig(**fields).validate()


def flatten(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def check_layout(cfg, rows: list[tuple]) -> None:
    """The reference's layout must be the program's tree, leaf for leaf."""
    from repro_torch.launch.steps import init_params

    prog = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in flatten(init_params(cfg, device="meta")).items()}
    ours = {r[0]: (tuple(r[1]), r[2]) for r in rows}
    if prog != ours:
        raise SystemExit(f"the reference's layout is not the program's: "
                         f"{sorted(set(prog.items()) ^ set(ours.items()))[:6]}")


class Spans:
    """The benchmark's own spans around its calls into the program's layers,
    each closed by a synchronize; named in the profiler as ``bench.<name>``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.times: dict[str, list[float]] = {}

    def wrap(self, name: str, fn):
        def spanned(*args, **kwargs):
            t = time.perf_counter()
            with torch.profiler.record_function(f"bench.{name}"):
                out = fn(*args, **kwargs)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            self.times.setdefault(name, []).append(time.perf_counter() - t)
            return out
        return spanned


def build(spec: dict, seed: int, device, spans: Spans | None = None):
    """The parameters from the seed, the optimizer state, the step and the
    loader: one object the set-up warms and the window drives."""
    from repro_torch.comm import ddp
    from repro_torch.data.pipeline import PrefetchLoader
    from repro_torch.optim.sgd import Optimizer, sgd

    c, t = spec["config"], spec["traffic"]
    if t["world"] != 1 or t["optimizer"] != "sgd":
        raise SystemExit(f"the harness drives one rank with SGD; the mix asks for "
                         f"world {t['world']}, {t['optimizer']}")
    cfg = program_config(c)
    rows = family(c).layout(c)
    check_layout(cfg, rows)
    flat = draw(rows, seed, device)
    params = nest(flat)
    opt = sgd(t["lr"], momentum=t["momentum"])
    state = opt.init(params)
    grads_of = ddp.loss_and_grads
    if spans is not None:
        opt = Optimizer(opt.init, spans.wrap("update", opt.update))
        ddp.loss_and_grads = spans.wrap("fwd_bwd", grads_of)
    step = ddp.make_ddp_train_step(cfg, opt, comm=None, sync_policy=t["sync_policy"])
    loader = PrefetchLoader(batches(seed, c["vocab_size"], t["rows"], t["seq_len"]),
                            depth=t["loader_depth"], device=device)
    return {"flat": flat, "params": params, "state": state, "step": step, "loader": loader,
            "rows": rows, "restore": lambda: setattr(ddp, "loss_and_grads", grads_of)}


def warm(prog: dict, steps: int, seed: int, device) -> dict:
    """The first ``steps`` steps, through the window's own call and feed, and
    the program's readings of them: each step's loss, each leaf's norm of
    the momentum after step 1 (the first gradient) and of the change after
    the last (the starting parameters drawn again from the seed)."""
    out: dict = {"loss": []}
    for i in range(steps):
        batch = next(prog["loader"])
        prog["params"], prog["state"], m = prog["step"](prog["params"], prog["state"], batch)
        out["loss"].append(float(m["loss"]))
        if i == 0:
            out["grad"] = check.norms(flatten(prog["state"]["mom"]))
    start = draw(prog["rows"], seed, device)
    out["change"] = check.change_norms(prog["flat"], start)
    del start
    return out


def release(prog: dict) -> None:
    """Stop the loader, undo the spans, and free the program's state."""
    prog["loader"].close()
    prog["restore"]()
    prog.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# The traced steps
# ----------------------------------------------------------------------
def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_trace(events, steps: int) -> dict:
    """From profiler events (``name``, ``device`` (bool), ``start``, ``end``
    in microseconds; the device track's copies of the benchmark's spans are
    not device work): the traced window (first ``bench.step`` start to last
    end), the device's busy seconds in it (union of device operations), each
    kernel name's launches and seconds, the ten longest idle gaps named by
    the innermost benchmark span the host was in when each began."""
    host = [e for e in events if not e[1] and e[0].startswith("bench.")]
    events = [e for e in events if not (e[1] and e[0].startswith("bench."))]
    step_spans = [e for e in host if e[0] == "bench.step"]
    if not step_spans:
        return {}
    lo, hi = min(e[2] for e in step_spans), max(e[3] for e in step_spans)
    dev = [e for e in events if e[1] and e[3] > lo and e[2] < hi]
    kernels: dict[str, list[float]] = {}
    for name, _, a, b in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) * 1e-6
    busy = _union([(max(a, lo), min(b, hi)) for _, _, a, b in dev])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = []
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            inside = [e for e in host if e[2] <= a < e[3] and e[0] != "bench.step"]
            name = min(inside, key=lambda e: e[3] - e[2])[0][6:] if inside else "step"
            gaps.append((name, (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return {"steps": steps, "wall_s": (hi - lo) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernels": kernels, "idle_gaps": gaps[:10]}


def traced_steps(prog: dict, spans: Spans, steps: int, device) -> dict:
    """``steps`` more steps under ``torch.profiler``, with the wrappers'
    launch counters read over them."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.device(device).type == "cuda" else [])
    kernels.reset_launches()
    one = spans.wrap("step", lambda: one_step(prog, spans))
    with profile(activities=acts) as prof:
        for _ in range(steps):
            one()
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.name, e.device_type == cuda, e.time_range.start, e.time_range.end)
              for e in prof.events()]
    out = reduce_trace(events, steps)
    out["launches"] = kernels.all_launches()
    return out


def one_step(prog: dict, spans: Spans | None = None) -> float:
    nxt = (lambda: next(prog["loader"])) if spans is None else \
        spans.wrap("data_wait", lambda: next(prog["loader"]))
    batch = nxt()
    prog["params"], prog["state"], m = prog["step"](prog["params"], prog["state"], batch)
    return float(m["loss"])


# ----------------------------------------------------------------------
# A run
# ----------------------------------------------------------------------
def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that the run may not hold, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(spec: dict, seed: int, seconds: float, trace: bool, device="cuda",
        t0: float | None = None) -> tuple[dict, list[str]]:
    """(the result line's object, the comparison's lines for stderr)."""
    t0 = time.perf_counter() if t0 is None else t0
    c, t = spec["config"], spec["traffic"]
    on_gpu = torch.device(device).type == "cuda"
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
    spans = Spans(device) if trace else None
    prog = build(spec, seed, device, spans)
    try:
        readings = warm(prog, t["check_steps"], seed, device)
        if on_gpu:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        if spans is not None:
            spans.times.clear()
        failed = 0
        start = time.perf_counter()
        ends = [start]
        while True:
            loss = one_step(prog, spans)
            ends.append(time.perf_counter())
            failed += not math.isfinite(loss)
            if ends[-1] - start >= seconds:
                break
        steps, window_s = len(ends) - 1, ends[-1] - start
        step_s = sorted(b - a for a, b in zip(ends, ends[1:]))
        window_spans = {k: list(v) for k, v in spans.times.items()} if spans else {}
        profile = traced_steps(prog, spans, t["profile_steps"], device) if trace else {}
        peak = torch.cuda.max_memory_allocated() if on_gpu else 0
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) if on_gpu else 0
    finally:
        release(prog)
    ref = check.follow(family(c), c, seed,
                       [b for _, b in zip(range(t["check_steps"]),
                                          batches(seed, c["vocab_size"], t["rows"],
                                                  t["seq_len"]))],
                       t["lr"], t["momentum"], device)
    numbers = check.gaps(readings, ref)
    limits = spec["limits"]
    correct = failed == 0 and all(numbers[k] <= limits[k] for k in limits)
    record = {"config": c, "traffic": t, "trace": trace,
              "window": {"steps": steps, "seconds": window_s,
                         "tokens": steps * t["rows"] * t["seq_len"]},
              "setup_s": setup_s, "peak_bytes": peak,
              "spans": window_spans, "profile": profile,
              "platform": "gpu" if on_gpu else "cpu",
              "power_limit_w": power_limit_w() if on_gpu else None}
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": record["platform"],
           "kind": torch.cuda.get_device_name() if on_gpu else "cpu",
           "count": 1, "memory_peak_bytes": peak, "power_limit_w": record["power_limit_w"]}
    if trace:
        dev.update(busy_s=profile.get("busy_s", 0.0), window_s=profile.get("wall_s", 0.0))
    result = {"correct": correct, "attempted": steps, "failed": failed, "metrics": metrics,
              "device": dev}
    if trace and profile:
        top = sorted(profile["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
        result["breakdown"] = {"device_ops": [[n[:120], s] for n, (_, s) in top],
                               "idle_gaps": [list(g) for g in profile["idle_gaps"]]}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    lines = [f"window: {steps} steps, a step {step_s[0]!r} / {step_s[len(step_s) // 2]!r} / "
             f"{step_s[-1]!r} s (least / median / most); allocator retries {retries}"]
    lines += [f"check {k}: {numbers[k]!r} limit {limits[k]!r}" for k in limits]
    lines.append(f"failed window steps: {failed} limit 0")
    return result, lines
