"""The rank jobs of ``tests/test_torch_seq_decode.py``, in a module of
their own so that the spawned ranks can import them.

A job is either ``{"arch", "reduced", "seq_len", "positions", "seed"}``:
:func:`repro_torch.launch.seq_decode.compare_decodes` at ``reduced()``
widths with those overrides; or ``{"kind": "attention", ...}``: one layer's
combine on arrays from an npz (:func:`_attention_job`).  Rank r writes
``rank<r>.json`` (a list, one entry a job).
"""
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.comm.sync import Comm
from repro_torch.configs import get_config
from repro_torch.launch.seq_decode import compare_decodes, shard_cache
from repro_torch.models.attention import decode_attention_seq_sharded


def _attention_job(rank: int, dev: torch.device, job: dict) -> dict:
    """:func:`decode_attention_seq_sharded` on arrays from ``job["inputs"]``
    (an npz of q, k_new, v_new and the whole cache's k and v, f32; ``pos``
    and ``window``), this rank's slice of the cache; writes the output and
    the slice after the write to ``job["out"]`` + ``.rank<r>.npz``."""
    world = torch.distributed.get_world_size()
    with np.load(job["inputs"]) as z:
        arrs = {k: torch.from_numpy(z[k]).to(dev) for k in ("q", "k_new", "v_new", "k", "v")}
    cache = shard_cache({"k": arrs["k"], "v": arrs["v"]}, rank, world)
    comm = Comm()
    out = decode_attention_seq_sharded(arrs["q"], arrs["k_new"], arrs["v_new"], cache,
                                       job["pos"], comm, window=job.get("window"))
    np.savez(f"{job['out']}.rank{rank}.npz", out=out.cpu().numpy(),
             k=cache["k"].cpu().numpy(), v=cache["v"].cpu().numpy())
    return {"kind": "attention", "rank": rank, "comm_bytes": comm.bytes,
            "comm_calls": comm.calls}


def _model_job(rank: int, dev: torch.device, job: dict) -> dict:
    cfg = get_config(job["arch"]).reduced(**job["reduced"])
    return {"arch": job["arch"],
            **compare_decodes(rank, dev, cfg, job["seq_len"], job["positions"], job["seed"])}


def run_rank(rank: int, dev: torch.device, jobs: list[dict], out_dir: str) -> None:
    results = [(_attention_job if job.get("kind") == "attention" else _model_job)(
        rank, dev, job) for job in jobs]
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(results, indent=2))
