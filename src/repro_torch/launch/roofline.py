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
the tables are bounds, never measured times.  The port's meshes are
data-parallel (``dp<N>``); the reference's ``16x16`` / ``2x16x16`` have
no records here.
"""
from __future__ import annotations

import argparse
import json
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
    lines = ["| arch | shape | mesh | lower s | temp GB/dev | arg GB/dev "
             "| collective GB | #coll ops | lowered PFLOP/dev |",
             "|---|---|---|---:|---:|---:|---:|---:|---:|"]
    for r in recs:
        mem = r.get("memory") or {}
        c = r.get("collectives") or {}
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r.get('lower_s') or 0:.1f} "
            f"| {(mem.get('temp_bytes') or 0) / 1e9:.2f} "
            f"| {(mem.get('argument_bytes') or 0) / 1e9:.2f} "
            f"| {(c.get('total_bytes') or 0) / 1e9:.2f} "
            f"| {c.get('total_count', 0)} "
            f"| {((r.get('cost_analysis') or {}).get('flops') or 0) / 1e15:.3f} |")
    return "\n".join(lines)


def roofline_table(recs: list[dict], mesh: str = "dp1") -> str:
    lines = ["| arch | shape | compute ms | memory ms | collective ms "
             "| dominant | MFU@bound | useful FLOPs |",
             "|---|---|---:|---:|---:|---|---:|---:|"]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        t = r["_terms"]
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {fmt_ms(t['compute'])} | {fmt_ms(t['memory'])} "
            f"| {fmt_ms(t['collective'])} | **{t['dominant']}** "
            f"| {t['mfu']:.3f} | {t['useful']:.2f} |")
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


def _mesh_order(label: str) -> int:
    return int(label[2:]) if label.startswith("dp") and label[2:].isdigit() else 1 << 30


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--results-dir", default=str(RESULTS))
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    recs = load(Path(args.results_dir))
    recs.sort(key=lambda r: (_mesh_order(r["mesh"]), r["arch"],
                             SHAPE_ORDER.index(r["shape"])))
    doc = ["# Dry-run artifacts", "", dryrun_table(recs), ""]
    for mesh in sorted({r["mesh"] for r in recs}, key=_mesh_order):
        n = next(r["n_devices"] for r in recs if r["mesh"] == mesh)
        doc += [f"# Roofline ({mesh}: {n} x NVIDIA H100 80GB HBM3, 700 W data-sheet "
                "peaks, not measured)", "", roofline_table(recs, mesh), ""]
    text = "\n".join(doc)
    print(text)
    if args.write:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text)
        print(f"\nwrote {out}")


if __name__ == "__main__":
    main()
