"""The port's sequence-sharded decode on the CPU: 2 gloo ranks
(``repro_torch.launch.seq_decode.compare_decodes`` through the jobs of
``tests/_seq_decode_jobs.py`` and ``measure.run.spawn_ranks``) against the
one-rank decode on the same cache, which ``tests/test_torch_decode.py``
holds to the reference's ``decode_step``: the logits, the cache, and each
attention layer's combine on the one-rank decode's inputs, which a combine
that drops the other rank's partials (the control) must miss;
the combine against the reference's own ``_decode_attention_seq_sharded``
under ``shard_map`` on two host devices; and the dry run's ``long_500k``
records at ``dp8``.

Reduced widths, float32; caches filled from a seeded generator, tokens
drawn from a seed.  Tolerance: 2e-4 of the one-rank tensors' scale, the
f32 ``_tol`` of ``tests/test_kernels.py``.  Cases: a ``G`` cache of 16
slots (8 a rank) decoded at positions in shard 0, across the boundary and
in shard 1; gemma3-1b's ``LG`` with an 8-slot ring buffer (4 a rank)
before and after it wraps; recurrentgemma-2b's ``RRL`` with the same ring.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import _seq_decode_jobs
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch import seq_decode as SD
from repro_torch.measure.run import spawn_ranks
from repro_torch.models import transformer as TT

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4
WORLD = 2

#: name -> (arch, reduced() overrides, cache length, positions decoded)
MODEL_CASES = {
    "G_shard0": ("qwen1.5-4b", {"num_layers": 2}, 16, [2, 3]),
    "G_boundary": ("qwen1.5-4b", {"num_layers": 2}, 16, [7, 8]),
    "G_shard1": ("qwen1.5-4b", {"num_layers": 2}, 16, [12, 13]),
    "L_before_wrap": ("gemma3-1b", {"num_layers": 2, "sliding_window": 8}, 32, [5, 6]),
    "L_after_wrap": ("gemma3-1b", {"num_layers": 2, "sliding_window": 8}, 32, [9, 10, 17]),
    "RRL": ("recurrentgemma-2b", {"num_layers": 3, "sliding_window": 8}, 16, [6, 7, 8, 9, 13]),
}
#: the reference's combine at one layer: (pos, window)
ATTN_CASES = {"attn_shard0": (5, None), "attn_shard1": (12, None), "attn_ring": (13, 8)}
B, H, K, HD, S = 2, 4, 2, 32, 16

REFERENCE_COMBINE = r"""
import sys
import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.models.attention import _decode_attention_seq_sharded

z = np.load(sys.argv[1])
pos = int(sys.argv[3])
mesh = Mesh(np.array(jax.devices()[:2]), ("seq",))

def body(q, kn, vn, k, v):
    out, cache = _decode_attention_seq_sharded(q, kn, vn, {"k": k, "v": v}, pos, "seq")
    return out, cache["k"], cache["v"]

f = jax.shard_map(body, mesh=mesh,
                  in_specs=(P(), P(), P(), P(None, "seq"), P(None, "seq")),
                  out_specs=(P(), P(None, "seq"), P(None, "seq")))
out, k, v = jax.jit(f)(*(z[n] for n in ("q", "k_new", "v_new", "k", "v")))
np.savez(sys.argv[2], out=np.asarray(out), k=np.asarray(k), v=np.asarray(v))
"""


def _attn_inputs(name, tmp: Path) -> Path:
    rng = np.random.default_rng(sorted(ATTN_CASES).index(name))
    arrs = {"q": (B, 1, H, HD), "k_new": (B, 1, K, HD), "v_new": (B, 1, K, HD),
            "k": (B, S, K, HD), "v": (B, S, K, HD)}
    path = tmp / f"{name}.in.npz"
    np.savez(path, **{n: rng.standard_normal(s).astype(np.float32) for n, s in arrs.items()})
    return path


def _reference_combine(inputs: Path, out: Path, pos: int) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           *filter(None, [os.environ.get("PYTHONPATH")])]))
    return subprocess.run([sys.executable, "-c", REFERENCE_COMBINE, str(inputs), str(out),
                           str(pos)], env=env, capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of 2 ranks for every case; the reference's combine in its
    own process beside it."""
    tmp = tmp_path_factory.mktemp("seq_decode")
    jobs = [{"arch": arch, "reduced": over, "seq_len": n, "positions": pos, "seed": i + 1}
            for i, (arch, over, n, pos) in enumerate(MODEL_CASES.values())]
    refs = {}
    for name, (pos, window) in ATTN_CASES.items():
        inputs = _attn_inputs(name, tmp)
        jobs.append({"kind": "attention", "inputs": str(inputs), "out": str(tmp / name),
                     "pos": pos, "window": window})
        if window is None:
            refs[name] = _reference_combine(inputs, tmp / f"{name}.ref.npz", pos)
    spawn_ranks(_seq_decode_jobs.run_rank, WORLD, "cpu", jobs, str(tmp))
    results = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(WORLD)]
    return {"tmp": tmp, "results": results, "refs": refs}


def _sharded_layers(cfg) -> int:
    pattern = (cfg.layer_pattern * cfg.num_units) + cfg.remainder_pattern
    return sum(kind in "GL" for kind in pattern)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_two_ranks_equal_the_one_rank_decode(runs, case):
    """Each rank's logits and cache (its slice of ``G`` and ``L``, its
    recurrent state) after every step, and each attention layer's combine,
    against the one-rank decode; the control's combine beyond the limit on
    some rank at every step (a rank whose slice holds every valid slot
    loses nothing by dropping the other's)."""
    i = list(MODEL_CASES).index(case)
    arch, over, _, positions = MODEL_CASES[case]
    cfg = get_config(arch).reduced(**over)
    for rank in range(WORLD):
        res = runs["results"][rank][i]
        assert res["arch"] == arch and res["rank"] == rank and res["world"] == WORLD
        assert [s["pos"] for s in res["steps"]] == positions
        for step in res["steps"]:
            assert step["logits_err"] <= TOL, (rank, step)
            assert step["cache_err"] <= TOL, (rank, step)
            assert step["attn_err"] <= TOL, (rank, step)
            n = _sharded_layers(cfg)
            assert step["comm_calls"] == 3 * n
            assert step["comm_bytes"] == n * cfg.num_heads * (cfg.head_size + 2) * 4
    for t in range(len(positions)):
        control = [runs["results"][rank][i]["steps"][t]["control_err"] for rank in range(WORLD)]
        assert max(control) > TOL, (positions[t], control)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_combine_equals_the_reference_under_shard_map(runs, case):
    """The port's ``decode_attention_seq_sharded`` on 2 gloo ranks against
    the reference's ``_decode_attention_seq_sharded`` under ``shard_map``
    on two forced host devices (a ``G`` cache: the reference shards no
    ring buffer), and a ring buffer against the one-rank ring decode."""
    pos, window = ATTN_CASES[case]
    tmp = runs["tmp"]
    ranks = [np.load(tmp / f"{case}.rank{r}.npz") for r in range(WORLD)]
    got_k = np.concatenate([r["k"] for r in ranks], axis=1)
    got_v = np.concatenate([r["v"] for r in ranks], axis=1)
    if window is None:
        proc = runs["refs"][case]
        assert proc.returncode == 0, proc.stderr[-3000:]
        want = np.load(tmp / f"{case}.ref.npz")
        want_out, want_k, want_v = want["out"], want["k"], want["v"]
    else:
        from repro_torch.kernels import ops

        z = np.load(tmp / f"{case}.in.npz")
        full_k = torch.from_numpy(z["k"]).clone()
        full_v = torch.from_numpy(z["v"]).clone()
        slot = pos % S
        full_k[:, slot] = torch.from_numpy(z["k_new"][:, 0])
        full_v[:, slot] = torch.from_numpy(z["v_new"][:, 0])
        valid = torch.arange(S) <= (S - 1 if pos >= S else slot)
        want_out = ops.decode_attention(torch.from_numpy(z["q"]), full_k, full_v, valid).numpy()
        want_k, want_v = full_k.numpy(), full_v.numpy()
    for r in ranks:
        scale = float(np.abs(want_out).max())
        assert np.abs(r["out"] - want_out).max() <= TOL * scale
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_v, want_v)


def test_a_string_seq_axis_raises():
    cfg = get_config("qwen1.5-4b").reduced(num_layers=2)
    params = TT.init_lm(cfg, seed=0)
    cache = TT.init_cache(cfg, 1, 4)
    with pytest.raises(TypeError, match="Comm"):
        TT.decode_step(cfg, params, cache, torch.zeros(1, dtype=torch.long), 0,
                       seq_axis="data")


@pytest.mark.parametrize("arch", ["gemma3-1b", "recurrentgemma-2b"])
def test_dry_run_lowers_long_500k_on_dp8(arch):
    """At one unit of published widths, ``long_500k`` on ``dp8`` lowers
    (``status: "ok"``), a rank's cache is its eighth of every ``G`` and
    ``L`` leaf, and the combine is counted: three all-reduces a sharded
    layer, B·H·(hd + 2)·4 bytes each layer."""
    cfg = get_config(arch)
    unit = len(cfg.layer_pattern)
    rec = dryrun.dryrun_one(arch, "long_500k", ranks=8, num_layers=unit)
    assert rec["status"] == "ok", rec.get("traceback")
    one = dryrun.dryrun_one(arch, "long_500k", ranks=1, num_layers=unit)
    layers = sum(kind in "GL" for kind in cfg.layer_pattern)
    assert rec["collectives"] == {
        "total_bytes": layers * cfg.num_heads * (cfg.head_size + 2) * 4,
        "total_count": 3 * layers,
        "bytes_by_op": {"all-reduce": layers * cfg.num_heads * (cfg.head_size + 2) * 4},
        "count_by_op": {"all-reduce": 3 * layers}}
    assert rec["memory"]["argument_bytes"] < one["memory"]["argument_bytes"]
    assert rec["kernel_calls"] == one["kernel_calls"]


def test_shard_cache_slices_the_sequence_axis():
    cfg = get_config("gemma3-1b").reduced(num_layers=2, sliding_window=8)
    full = SD.fill_cache(TT.init_cache(cfg, 1, 32), seed=3)
    parts = [SD.shard_cache(full, r, 4) for r in range(4)]
    for path, t in TT.leaf_order(full):
        pieces = [TT.get_path(p, path) for p in parts]
        assert torch.equal(torch.cat(pieces, dim=-3), t), path
        assert pieces[0].shape[-3] == t.shape[-3] // 4
    with pytest.raises(ValueError, match="do not split"):
        SD.shard_cache(full, 0, 3)
