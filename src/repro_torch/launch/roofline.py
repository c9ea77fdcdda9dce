"""Roofline report: the dry run's records (``results/dryrun_torch/*.json``,
:mod:`repro_torch.launch.dryrun`) -> markdown tables.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--results-dir D] \\
        [--write] [--out results/roofline_torch.md]

Counterpart of :mod:`repro.launch.roofline`, priced against one NVIDIA H100
80GB HBM3 at 700 W instead of a TPU v5e chip: the data-sheet peaks of
:mod:`repro_torch.kernels.cost` (989e12 bfloat16 FLOP/s, 3.35e12 HBM
bytes/s, and for the collective term NVLink 4's 450e9 bytes/s in one
direction).  These are the card's published peaks, not measurements, so a
term is the least time the card could take for that part of the step, and
the tables are bounds, never measured times.  The records are the port's
data-parallel ``dp<N>`` meshes and the reference's ``16x16`` /
``2x16x16`` (under ``zero3``, ``fsdp2d``, ``fsdp`` and ``pure_dp``); one
roofline table is made for each (mesh, mode), and :func:`modes_table`
sets ``train_4k``'s side by side.  The compute term is the reference's:
analytic FLOPs over the chips.  Beside it stands the record's lowered
FLOPs of one rank: under ``fsdp2d`` the ``model`` ranks of a data shard
repeat its compute, so the analytic FLOPs over the chips count a rank's
work short by the ``model`` axis' size; under ``fsdp`` and ``pure_dp`` on
a mesh with ``model`` they split it (tensor parallelism), but for the
parts the rules leave whole there (attention whose heads do not divide
``model``, the MoE router).
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import torch

from repro_torch.kernels.cost import NVLINK_BYTES_PER_S, PEAK_BYTES_PER_S, PEAK_FLOPS

ROOT = Path(__file__).resolve().parents[3]
RESULTS = ROOT / "results" / "dryrun_torch"
OUT = ROOT / "results" / "roofline_torch.md"

PEAK_FLOPS_BF16 = PEAK_FLOPS[torch.bfloat16]
SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def terms(rec: dict) -> dict:
    chips = rec["n_devices"]
    ana = rec["analytic"]
    coll = (rec.get("collectives") or {}).get("total_bytes", 0.0)
    t = {
        "compute": ana["flops"] / (chips * PEAK_FLOPS_BF16),
        "memory": ana["hbm_bytes"] / (chips * PEAK_BYTES_PER_S),
        "collective": coll / NVLINK_BYTES_PER_S,
    }
    dom = max(t, key=lambda k: t[k])
    bound = t[dom]
    mfu = (ana["model_flops"] / (chips * PEAK_FLOPS_BF16)
           / max(bound, 1e-12))
    return {**t, "dominant": dom, "bound": bound, "mfu": mfu,
            "useful": (ana["model_flops"] / ana["flops"]
                       if ana["flops"] else 0.0)}


def load(results_dir: Path = RESULTS) -> list[dict]:
    recs = []
    for p in sorted(results_dir.glob("*.json")):
        r = json.loads(p.read_text())
        if r.get("status") == "ok":
            r["_terms"] = terms(r)
            recs.append(r)
    return recs


def fmt_ms(s: float) -> str:
    return f"{s * 1e3:9.2f}"


def dryrun_table(recs: list[dict]) -> str:
    lines = ["| arch | shape | mesh | mode | lower s | temp GB/dev | arg GB/dev "
             "| collective GB | #coll ops | lowered PFLOP/dev |",
             "|---|---|---|---|---:|---:|---:|---:|---:|---:|"]
    for r in recs:
        mem = r.get("memory") or {}
        c = r.get("collectives") or {}
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r.get('mode', 'pure_dp')} "
            f"| {r.get('lower_s') or 0:.1f} "
            f"| {(mem.get('temp_bytes') or 0) / 1e9:.2f} "
            f"| {(mem.get('argument_bytes') or 0) / 1e9:.2f} "
            f"| {(c.get('total_bytes') or 0) / 1e9:.2f} "
            f"| {c.get('total_count', 0)} "
            f"| {((r.get('cost_analysis') or {}).get('flops') or 0) / 1e15:.3f} |")
    return "\n".join(lines)


def _key(r: dict) -> tuple[str, str]:
    return r["mesh"], r.get("mode", "pure_dp")


def roofline_table(recs: list[dict], mesh: str = "dp1", mode: str = "pure_dp") -> str:
    lines = ["| arch | shape | compute ms | lowered ms/rank | memory ms | collective ms "
             "| dominant | MFU@bound | useful FLOPs |",
             "|---|---|---:|---:|---:|---:|---|---:|---:|"]
    for r in recs:
        if _key(r) != (mesh, mode):
            continue
        t = r["_terms"]
        lowered = ((r.get("cost_analysis") or {}).get("flops") or 0) / PEAK_FLOPS_BF16
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {fmt_ms(t['compute'])} | {fmt_ms(lowered)} | {fmt_ms(t['memory'])} "
            f"| {fmt_ms(t['collective'])} | **{t['dominant']}** "
            f"| {t['mfu']:.3f} | {t['useful']:.2f} |")
    return "\n".join(lines)


#: one card's memory: what a rank's arguments + temporaries must fit
CARD_BYTES = 80e9


def modes_table(recs: list[dict], shape: str = "train_4k") -> str:
    """Per arch, each (mesh, mode) record of ``shape``: a rank's arguments +
    temporaries, its collectives' GB by op, its lowered FLOPs beside the
    analytic FLOPs over the chips, and whether it fits one 80 GB card."""
    lines = ["| arch | mesh | mode | args + temps GB/rank | all-gather GB | reduce-scatter GB "
             "| all-reduce GB | lowered TFLOP/rank | analytic TFLOP/chip | lowered / analytic "
             "| fits 80 GB |", "|---|---|---|---:|---:|---:|---:|---:|---:|---:|---|"]
    for r in sorted((r for r in recs if r["shape"] == shape),
                    key=lambda r: (r["arch"], _mesh_order(r["mesh"]), r.get("mode", ""))):
        mem, by_op = r["memory"], r["collectives"].get("bytes_by_op", {})
        held = mem["argument_bytes"] + mem["temp_bytes"]
        lowered = r["cost_analysis"]["flops"]
        analytic = r["analytic"]["flops"] / r["n_devices"]
        lines.append(
            f"| {r['arch']} | {r['mesh']} | {r.get('mode', 'pure_dp')} | {held / 1e9:.2f} "
            + "".join(f"| {by_op.get(op, 0) / 1e9:.3f} "
                      for op in ("all-gather", "reduce-scatter", "all-reduce"))
            + f"| {lowered / 1e12:.1f} | {analytic / 1e12:.1f} | {lowered / analytic:.2f} "
            f"| {'yes' if held <= CARD_BYTES else 'no'} |")
    return "\n".join(lines)


def pick_hillclimb(recs: list[dict], mesh: str = "dp1") -> list[dict]:
    """Worst roofline fraction (MFU at the bound) among ``mesh``'s training
    records, and the most collective-bound record."""
    pod = [r for r in recs if r["mesh"] == mesh]
    worst_mfu = min((r for r in pod if r["shape"] == "train_4k"),
                    key=lambda r: r["_terms"]["mfu"], default=None)
    most_coll = max(pod, key=lambda r: r["_terms"]["collective"],
                    default=None)
    return [worst_mfu, most_coll]


def _mesh_order(label: str) -> tuple[int, int]:
    """``dp<N>`` by N, then ``16x16`` and ``2x16x16`` by their chips."""
    if label.startswith("dp") and label[2:].isdigit():
        return 0, int(label[2:])
    return 1, math.prod(int(n) for n in label.split("x"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--results-dir", default=str(RESULTS))
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    recs = load(Path(args.results_dir))
    recs.sort(key=lambda r: (_mesh_order(r["mesh"]), r.get("mode", "pure_dp"), r["arch"],
                             SHAPE_ORDER.index(r["shape"])))
    doc = ["# Dry-run artifacts", "", dryrun_table(recs), ""]
    for mesh, mode in sorted({_key(r) for r in recs}, key=lambda k: (_mesh_order(k[0]), k[1])):
        n = next(r["n_devices"] for r in recs if _key(r) == (mesh, mode))
        label = mesh if mode == "pure_dp" else f"{mesh}, {mode}"
        doc += [f"# Roofline ({label}: {n} x NVIDIA H100 80GB HBM3, 700 W data-sheet "
                "peaks, not measured)", "", roofline_table(recs, mesh, mode), ""]
        if mode == "fsdp2d":
            doc += ["Compute is the analytic FLOPs over the chips; under fsdp2d the "
                    "model ranks of a data shard repeat its compute, so it counts a rank's "
                    "work short by the model axis' size: the lowered ms/rank column is "
                    "the record's own FLOPs of one rank at the same peak.", ""]
    if len({_key(r) for r in recs if r["shape"] == "train_4k"}) > 1:
        doc += ["# train_4k by mesh and mode (a rank of one NVIDIA H100 80GB HBM3)", "",
                modes_table(recs), ""]
    text = "\n".join(doc)
    print(text)
    if args.write:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text)
        print(f"\nwrote {out}")


if __name__ == "__main__":
    main()
