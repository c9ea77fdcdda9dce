"""Measurement runner / CLI: ``python -m repro_torch.measure --arch <id>``.

Counterpart of :mod:`repro.measure.run`.  Spawns the data-parallel ranks
(``torch.multiprocessing``, a ``file://`` rendezvous in a temporary
directory, so parallel runs never collide on a port), measures in every
rank (:func:`repro_torch.measure.harness.measure_model`) and writes two
artifacts into the output directory:

* ``<arch>.trace`` — the paper-format per-layer trace, which the
  unchanged ``python -m repro.launch.sweep --workloads trace:<file>``
  evaluates;
* ``<arch>.json`` — per-policy step times, counted all-reduce bytes and
  their cross-check, the alpha-beta fit, segmentation, kernel launches.

By default the model is the arch at its published widths with the depth
cut to ``--num-layers`` (default: one whole layer pattern and at least two
layers; qwen1.5-4b, recurrentgemma-2b, rwkv6-1.6b, gemma3-1b,
internlm2-20b, qwen1.5-32b and qwen2-moe-a2.7b are measured so, qwen1.5-32b
also at ``--num-layers 1``; grok-1-314b, whose one layer holds 4.9 G
parameters, only ``reduced()``);
giving any of ``--d-model``, ``--num-heads``, ``--d-ff`` or
``--vocab-size`` measures a ``reduced()`` variant instead, and ``--smoke``
picks the reference's tiny CI preset.  The ranks share one device: the
backend is gloo, which also takes CUDA tensors (NCCL refuses two ranks on
one card).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.device import resolve_device

MEASURABLE_ARCHS = ("qwen1.5-4b", "recurrentgemma-2b", "rwkv6-1.6b", "gemma3-1b",
                    "internlm2-20b", "qwen1.5-32b", "qwen2-moe-a2.7b", "grok-1-314b")
BACKEND = "gloo"

_WIDTHS = ("d_model", "num_heads", "d_ff", "vocab_size")


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Model and measurement geometry; widths left None are the arch's
    published ones, and ``num_layers`` None is :func:`default_num_layers`."""

    num_layers: int | None = None
    d_model: int | None = None
    num_heads: int | None = None
    d_ff: int | None = None
    vocab_size: int | None = None
    seq_len: int = 1024
    batch_per_gpu: int = 2
    n_devices: int = 2
    repeats: int = 3
    step_iters: int = 3


#: The reference's ``SMOKE_GEOMETRY`` (``repro.measure.run``).
SMOKE_GEOMETRY = Geometry(num_layers=4, d_model=128, num_heads=4, d_ff=256,
                          vocab_size=512, seq_len=32, batch_per_gpu=2,
                          n_devices=2, repeats=3, step_iters=4)


def default_num_layers(cfg) -> int:
    """One whole pattern unit, and at least two layers: qwen1.5-4b (``G``)
    and rwkv6-1.6b (``W``) get 2 layers (2 units), recurrentgemma-2b
    (``RRL``) 3 and gemma3-1b (``LLLLLG``) 6 (one unit), so segmentation
    has a unit at both of its depths."""
    return max(2, len(cfg.layer_pattern))


def config_for(arch: str, g: Geometry):
    """The measured config: published widths at depth ``g.num_layers``, or
    ``reduced()`` when any width is given."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    num_layers = default_num_layers(cfg) if g.num_layers is None else g.num_layers
    widths = {f: getattr(g, f) for f in _WIDTHS if getattr(g, f) is not None}
    if widths:
        return cfg.reduced(num_layers=num_layers, **widths)
    return dataclasses.replace(cfg, num_layers=num_layers).validate()


def _rank_entry(rank: int, world: int, init_file: str, device: str, fn, args: tuple) -> None:
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        # every rank on the one card (gloo; NCCL refuses two ranks per card)
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    else:
        # one thread a rank: the CPU path runs small models (the smoke
        # preset, the tests), whose many small operators, split over several
        # threads, stall at every parallel region's barrier whenever other
        # processes hold the host's cores
        torch.set_num_threads(1)
    dist.init_process_group(BACKEND, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        fn(rank, dev, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, device: str | None, *args, meanwhile=None):
    """Run ``fn(rank, device, *args)`` in ``world`` spawned processes that
    form the default process group (gloo, a ``file://`` rendezvous in a
    temporary directory), all on one ``device`` (default CUDA, which raises
    without a GPU).  ``fn`` must be a module-level function.  ``meanwhile``,
    if given, is called here while the ranks run; its result is returned
    once they have ended."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if dev.type == "cuda":
        # build once here, so the ranks never race on the build directory
        from repro_torch.kernels import load_libraries
        load_libraries()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(_rank_entry, nprocs=world, join=False,
                       args=(world, os.path.join(tmp, "rendezvous"), str(dev), fn, args))
        try:
            result = meanwhile() if meanwhile is not None else None
        finally:
            while not ctx.join():
                pass
    return result


def _measure_rank(rank: int, dev: torch.device, arch: str, out_dir: str, geometry: Geometry,
                  policies: tuple[str, ...] | None) -> None:
    from repro_torch.measure.harness import MEASURED_SYNC_POLICIES, measure_model

    g = geometry
    cfg = config_for(arch, g)
    run = measure_model(cfg, device=dev, arch=arch, batch_per_gpu=g.batch_per_gpu,
                        seq_len=g.seq_len,
                        policies=policies or MEASURED_SYNC_POLICIES,
                        repeats=g.repeats, step_iters=g.step_iters)
    if rank == 0:
        _write(run, cfg, Path(out_dir))


def _write(run, cfg, out_dir: Path) -> dict:
    from repro_torch.measure import calibrate
    from repro_torch.traces.format import write_trace

    out_dir.mkdir(parents=True, exist_ok=True)
    trace_path = out_dir / f"{run.arch}.trace"
    write_trace(run.trace, trace_path)
    latency, bandwidth = calibrate.fit_alpha_beta(run.allreduce_samples)
    doc = dict(run.summary())
    doc.update({
        "workload": f"trace:{trace_path}",
        "trace_path": str(trace_path),
        "cluster": run.trace.cluster,
        "allreduce_fit": {"latency_s": latency, "bandwidth_bytes_per_s": bandwidth},
        "bytes_crosscheck": {
            pol: {"counted_bytes": float(n),
                  "expected_bytes": calibrate.expected_collective_bytes(cfg, pol)}
            for pol, n in run.counted_bytes.items()},
    })
    (out_dir / f"{run.arch}.json").write_text(json.dumps(doc, indent=2))
    return doc


def run_measurement(arch: str, out_dir: str | Path, geometry: Geometry,
                    policies: tuple[str, ...] | None = None,
                    device: str | None = None) -> dict:
    """Spawn ``geometry.n_devices`` ranks, measure ``arch``, write
    ``<arch>.trace`` + ``<arch>.json`` into ``out_dir`` and return the JSON
    document.  ``device`` defaults to CUDA (raises without a GPU)."""
    if arch not in MEASURABLE_ARCHS:
        raise ValueError(f"arch {arch!r} not measurable yet; one of {MEASURABLE_ARCHS}")
    spawn_ranks(_measure_rank, geometry.n_devices, device, arch, str(out_dir), geometry,
                policies)
    return json.loads((Path(out_dir) / f"{arch}.json").read_text())


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------
_FLAG_OVERRIDES = {"n_devices": "--devices"}


def _geometry_flag(field_name: str) -> str:
    return _FLAG_OVERRIDES.get(field_name, "--" + field_name.replace("_", "-"))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch.measure",
        description="Measure the port's S-SGD train step into a paper-format trace.")
    p.add_argument("--arch", required=True, choices=MEASURABLE_ARCHS)
    p.add_argument("--out-dir", default="results/measure_torch",
                   help="output directory (default: results/measure_torch)")
    full, smoke = Geometry(), SMOKE_GEOMETRY
    for f in dataclasses.fields(Geometry):
        default = "max(2, len(layer_pattern))" if f.name == "num_layers" else \
            getattr(full, f.name)
        p.add_argument(_geometry_flag(f.name), type=int, default=None, dest=f.name,
                       help=f"default {default} (--smoke: {getattr(smoke, f.name)})")
    p.add_argument("--policies", default=None,
                   help="comma-separated sync policies (default: at_end,wfbp,bucketed)")
    p.add_argument("--smoke", action="store_true",
                   help="the reference's tiny CI geometry (geometry flags still win)")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="default cuda; cpu must be asked for")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    base = SMOKE_GEOMETRY if args.smoke else Geometry()
    geometry = dataclasses.replace(base, **{
        f.name: getattr(args, f.name) for f in dataclasses.fields(Geometry)
        if getattr(args, f.name) is not None})
    policies = tuple(t.strip() for t in args.policies.split(",") if t.strip()) \
        if args.policies else None
    doc = run_measurement(args.arch, args.out_dir, geometry, policies, args.device)
    brief = {k: doc[k] for k in ("workload", "device", "cluster", "policy_times_s",
                                 "policy_losses", "t_update_s", "allreduce_fit", "bytes_crosscheck",
                                 "kernel_launches", "elapsed_s")}
    print(json.dumps(brief, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
