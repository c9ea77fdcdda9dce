"""Tensor and expert parallelism on the ``model`` axis (the ``fsdp`` mode, and
``pure_dp`` on a 2-D mesh) on 4 gloo CPU ranks of a ``{data: 2, model: 2}``
mesh, against the reference's own jitted SPMD step.

The reference (``tests/_sharded_reference.py``, in a subprocess on 4 forced
host devices) jits ``repro.launch.steps.make_train_step`` with the
``in_shardings`` of ``named_shardings`` under ``ShardingConfig(("data",
"model"), mode)`` on ``make_cpu_mesh(2, 2)``, and XLA's partitioner places
every collective; the port's ranks (``tests/_sharded_jobs.py``) run
``repro_torch.launch.sharded_step.sharded_train`` from the same
``PRNGKey(0)`` parameters and batch, each block on its slices with the
collectives of ``repro_torch.comm.tensor_parallel``.  Checked per case: the
loss within 1e-5 relative (the mean of the ranks' losses); ``grad_norm``
and every gathered parameter and momentum leaf within 2e-4 of the
reference leaf's scale (``_tol`` of ``tests/test_kernels.py``); each rank's
slice equal to the block ``NamedSharding.devices_indices_map`` gives the
device at its mesh coordinate (two dims split where a leaf is on both
``data`` and ``model``); the control, which skips the division, beyond the
limit; each rank's collectives by op equal to the dry run's
(``repro_torch.launch.dryrun.lower``).  Under ``fsdp`` the prefill logits and
4 decode steps (the cache sequence-sharded over ``model``, the logits'
vocabulary gathered) against the reference's ``forward`` and
``decode_step``.  And the runner's comparison of ``fsdp`` with ``pure_dp``
on the same rows (``sharded_step.compare_steps`` and ``check``).

The cases, at reduced widths in float32, each splitting something over
``model``: recurrentgemma-2b with a 16 384 vocabulary (the vocab-parallel
chunked cross-entropy, a tied embedding), 2 of 4 q heads a rank on its one
replicated kv head, the RG-LRU on half the width; rwkv6-1.6b (2 of 4 wkv
heads, row-parallel ``wv`` / ``wo``) on the draw of ``tests/
test_torch_sharded.py`` (its module docstring says why); qwen2-moe-a2.7b
with 8 experts (4 a rank) under ``fsdp`` and with 5 (ff-split experts, a
whole ``wo``: the production layout of 60 and 8 experts on 16) under
``pure_dp``; whisper-tiny (encoder, ``C`` blocks, the vocabulary of 512
split); and a GQA shape of 6 q heads on 3 kv heads, whose 3 local q heads
read kv heads 0, 0, 1 (one a q head, repeated).  ``xattn/bk`` (whisper-tiny)
has a gradient of 0 in exact arithmetic; its round-off is held to the
largest leaf's scale.
"""
import pickle

import _sharded_jobs
import numpy as np
import pytest

from repro_torch.comm.tensor_parallel import kv_heads, model_slice
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch import sharded_step as SS

SIZES = _sharded_jobs.SIZES
WORLD = 4
TOL = 2e-4
LOSS_RTOL = 1e-5

#: name -> (arch, overrides of ``reduced()``, mode, accum_steps, remat)
CASES = {
    "rg_fsdp": ("recurrentgemma-2b", {"num_layers": 3, "vocab_size": 16384}, "fsdp", 1, True),
    "rwkv_fsdp": ("rwkv6-1.6b", {"num_layers": 2}, "fsdp", 1, False),
    "moe_fsdp": ("qwen2-moe-a2.7b", {"num_layers": 2, "num_experts": 8}, "fsdp", 2, True),
    "moe_pure_dp": ("qwen2-moe-a2.7b", {"num_layers": 2, "num_experts": 5}, "pure_dp", 1,
                    True),
    "whisper_fsdp": ("whisper-tiny", {"num_layers": 2}, "fsdp", 1, True),
    "gqa_fsdp": ("internlm2-20b", {"num_layers": 2, "num_heads": 6, "num_kv_heads": 3,
                                   "d_model": 192}, "fsdp", 1, False),
}
#: the global batch of each case: (rows, tokens a row, the seed of its draw)
BATCH = {"rg_fsdp": (8, 32, 0), "rwkv_fsdp": (4, 80, 4), "moe_fsdp": (8, 32, 2),
         "moe_pure_dp": (8, 32, 2), "whisper_fsdp": (8, 32, 3), "gqa_fsdp": (8, 32, 5)}
SERVE = [name for name, case in CASES.items() if case[2] == "fsdp"]
#: serve-only overrides (``tests/test_torch_sharded.py``'s ``SERVE_OVER``)
SERVE_OVER = {"qwen2-moe-a2.7b": {"capacity_factor": 2.0}}
RUNNER = {"kind": "runner", "name": "runner", "arch": "recurrentgemma-2b",
          "reduced": {"num_layers": 3}, "sizes": SIZES, "mode": "fsdp",
          "global_batch": 4, "seq_len": 32, "accum_steps": 1, "remat": True}


def _cfg(name: str):
    arch, over = CASES[name][:2]
    return get_config(arch).reduced(**over)


def _case(name: str) -> dict:
    """A case of ``_sharded_jobs`` / ``_sharded_reference``: its arch is the
    case's name, so that each case has its own parameters and batch."""
    arch, over, mode, accum, remat = CASES[name]
    return {"name": name, "arch": arch, "reduced": over, "mode": mode, "accum_steps": accum,
            "remat": remat, "serve": name in SERVE, "serve_over": SERVE_OVER.get(arch, {}),
            "key": name}


def _batch(name: str) -> dict:
    cfg = _cfg(name)
    rows, seq, seed = BATCH[name]
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.arch_type == "audio":
        batch["frames"] = rng.standard_normal(
            (rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    cases = [_case(name) for name in CASES]
    records = _sharded_jobs.run_against_reference(
        tmp, cases, {name: _batch(name) for name in CASES}, [RUNNER], WORLD)
    return {"tmp": tmp, "ranks": {job["name"]: ranks
                                  for job, ranks in zip([*cases, RUNNER], records)}}


def _pkl(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _leaf(tree, path: str):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return np.asarray(tree)


def _scaled(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_norm_match_the_reference(runs, name):
    ref = _pkl(runs["tmp"] / f"ref_{name}.pkl")["metrics"]
    ranks = runs["ranks"][name]
    for key in ("total_loss", "loss", "moe_aux"):
        got = sum(r["metrics"][key] for r in ranks) / WORLD
        assert abs(got - ref[key]) <= LOSS_RTOL * max(abs(ref[key]), 1e-30) or \
            key == "moe_aux" and ref[key] == got == 0.0, (key, got, ref[key])
    for r in ranks:   # the norm of the whole gradient on every rank
        assert abs(r["metrics"]["grad_norm"] - ref["grad_norm"]) <= TOL * ref["grad_norm"]


@pytest.mark.parametrize("name", list(CASES))
def test_parameters_and_momentum_match_the_reference(runs, name):
    ref = _pkl(runs["tmp"] / f"ref_{name}.pkl")
    with np.load(runs["tmp"] / f"port_{name}.npz") as port:
        paths = [k.removeprefix("params/") for k in port.files if k.startswith("params/")]
        assert sorted(paths) == sorted(ref["slices"])
        for tree in ("params", "mom"):
            top = max(float(np.abs(_leaf(ref[tree], path)).max()) for path in paths)
            for path in paths:
                want = _leaf(ref[tree], path)
                # xattn/bk: 0 in exact arithmetic (module docstring)
                scale = top if path.endswith("xattn/bk") else float(np.abs(want).max())
                err = float(np.abs(port[f"{tree}/{path}"] - want).max()) / max(scale, 1e-30)
                assert err <= TOL, (tree, path, err)


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_the_reference_devices_block(runs, name):
    """Rank r at mesh coordinate (d, m) holds exactly the block the
    reference's ``NamedSharding`` puts on ``mesh.devices[d, m]``; some
    leaves are split over ``model``, and under ``fsdp`` some over ``data``
    and ``model`` both."""
    ref = _pkl(runs["tmp"] / f"ref_{name}.pkl")
    params = _pkl(runs["tmp"] / f"params_{name}.pkl")
    ways = set()
    for r, res in enumerate(runs["ranks"][name]):
        d, m = res["coords"]["data"], res["coords"]["model"]
        assert r == 2 * d + m
        with np.load(runs["tmp"] / f"shards_{name}.rank{r}.npz") as shards:
            for path, blocks in ref["slices"].items():
                whole = _leaf(params, path)
                block = tuple(slice(a, b) for a, b in blocks[2 * d + m])
                np.testing.assert_array_equal(shards[path], whole[block], err_msg=path)
                ways.add(whole.size // shards[path].size)
    assert 1 in ways and ways & {2, 4}
    assert (4 in ways) == (CASES[name][2] == "fsdp"), ways


@pytest.mark.parametrize("name", list(CASES))
def test_the_control_misses_the_reference(runs, name):
    """Without the division by the batch axes' size the momentum is 2x the
    synchronized gradient: beyond the limit."""
    ref = _pkl(runs["tmp"] / f"ref_{name}.pkl")
    with np.load(runs["tmp"] / f"port_{name}.npz") as port:
        worst = max(_scaled(port[f"control/{path}"], _leaf(ref["mom"], path))
                    for path in ref["slices"])
    assert worst > TOL


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_equal_the_dry_run(runs, name):
    arch, over, mode, accum, remat = CASES[name]
    rows, seq, _ = BATCH[name]
    rec = dryrun.lower(_cfg(name), InputShape(name, seq, rows, "train"), mesh=SIZES,
                       mode=mode, remat=remat, accum_steps=accum, device="meta")
    col = rec["collectives"]
    assert col["count_by_op"]["all-reduce"] > 0
    for res in runs["ranks"][name]:
        assert res["count_by_op"] == col["count_by_op"]
        assert res["bytes_by_op"] == col["bytes_by_op"]


@pytest.mark.parametrize("name", SERVE)
def test_fsdp_prefill_and_decode_match_the_reference(runs, name):
    ref = _pkl(runs["tmp"] / f"serve_{name}.pkl")
    rows = []
    for r in range(WORLD):
        with np.load(runs["tmp"] / f"serve_{name}.rank{r}.npz") as got:
            rows.extend(got["rows"].tolist())
            assert _scaled(got["prefill"], ref["prefill"][got["rows"]]) <= TOL
            for t in range(got["decode"].shape[0]):
                assert _scaled(got["decode"][t], ref["decode"][t][got["rows"]]) <= TOL, t
    # the batch split over data: each row on the 2 model ranks of its data shard
    assert sorted(rows) == sorted(2 * list(range(BATCH[name][0])))


def test_runner_against_pure_dp(runs):
    """``compare_steps`` / ``check``: fsdp against pure_dp on the same rows
    of the same 4 ranks, the control beyond the limit, the counts the dry
    run's."""
    ranks = runs["ranks"]["runner"]
    dry = SS.dry_run(RUNNER)
    assert SS.check(RUNNER, ranks, dry, on_cuda=False) == []
    assert all(r["control_mom_err"] > SS.F32_LIMIT for r in ranks)
    broken = [dict(r, count_by_op={**r["count_by_op"], "all-reduce": 0}) for r in ranks]
    assert SS.check(RUNNER, broken, dry, on_cuda=False)


@pytest.mark.parametrize("heads,kv,size,want", [
    # llama-3.2-vision-90b: 64 q heads on 8 kv heads over 16 ranks
    (64, 8, 16, {0: ([0], 4), 1: ([0], 4), 2: ([1], 4), 15: ([7], 4)}),
    # internlm2-20b and grok-1-314b: 48 on 8 over 16
    (48, 8, 16, {0: ([0], 3), 1: ([0], 3), 2: ([1], 3), 15: ([7], 3)}),
    # whole groups of several kv heads: 20 on 4 over 2
    (20, 4, 2, {0: ([0, 1], 5), 1: ([2, 3], 5)}),
    # uneven: 6 on 3 over 2, and 12 on 4 over 6, where rank 1 reads two kv heads once each
    (6, 3, 2, {0: ([0, 0, 1], 1), 1: ([1, 2, 2], 1)}),
    (12, 4, 6, {0: ([0], 2), 1: ([0, 1], 1), 2: ([1], 2)}),
])
def test_kv_head_choice(heads, kv, size, want):
    """The kv heads a rank's q heads read: each of a whole group's once,
    with its group; else one a q head, repeated."""
    for index, expected in want.items():
        assert kv_heads(heads, kv, size, index) == expected
    for index in range(size):
        idx, group = kv_heads(heads, kv, size, index)
        local = heads // size
        read = [h // (heads // kv) for h in range(index * local, (index + 1) * local)]
        assert [k for k in idx for _ in range(group)] == read


def test_model_slice_reads_the_spec():
    sizes, coords = {"data": 2, "model": 4}, {"data": 1, "model": 3}
    assert model_slice(("data", "model"), (64, 40), sizes, coords) == (1, 30, 40)
    assert model_slice(("model", "data"), (32, 64), sizes, coords) == (0, 24, 32)
    assert model_slice(("data", None), (64, 40), sizes, coords) is None
    assert model_slice((None, ("data", "model")), (8, 64), sizes, coords) is None


def test_cli_runs_one_job(capsys):
    """``python -m repro_torch.launch.sharded_step`` on 4 CPU ranks: a rank's
    record a line, then the dry run's counts and no finding."""
    import json

    assert SS.main(["--arch", "rwkv6-1.6b", "--reduced", '{"num_layers": 1}',
                    "--mesh", "data=2,model=2", "--global-batch", "2", "--seq-len", "16",
                    "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [ln["rank"] for ln in lines[:-1]] == [0, 1, 2, 3]
    assert all(ln["mom_err"] <= SS.F32_LIMIT < ln["control_mom_err"] for ln in lines[:-1])
    assert lines[-1]["findings"] == [] and lines[-1]["dry_run_collectives"]["all-reduce"] > 0


def test_cli_runs_the_bf16_witness(capsys):
    """``--bf16-witness``: each rank's record carries the bfloat16 mode's and
    bfloat16 pure_dp's distances from float32 pure_dp, the mode's within
    ``WITNESS_RATIO`` of pure_dp's, and the bfloat16 counts, which equal the
    bfloat16 dry run's (no finding)."""
    import json

    assert SS.main(["--arch", "recurrentgemma-2b", "--reduced",
                    '{"num_layers": 3, "vocab_size": 16384}', "--mesh", "data=2,model=2",
                    "--global-batch", "2", "--seq-len", "32", "--device", "cpu",
                    "--bf16-witness"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines[-1]["findings"] == []
    for ln in lines[:-1]:
        w = ln["bf16"]
        assert ln["dtype"] == "float32" and ln["mom_err"] <= SS.F32_LIMIT
        assert 0 < w["mode_err"] <= SS.WITNESS_RATIO * w["pure_dp_err"]
        assert w["mode_vs_pure_dp_err"] > 0 and w["count_by_op"]["all-reduce"] > 0


def test_the_witness_check_finds_a_mode_beyond_the_ratio():
    """``check_witness`` on records whose bfloat16 mode lies beyond
    ``WITNESS_RATIO`` times pure_dp's distance, or whose counts or peak
    miss the dry run's."""
    dry = {"collectives": {"bytes_by_op": {"all-reduce": 8}, "count_by_op": {"all-reduce": 1}},
           "memory": {"argument_bytes": 60, "temp_bytes": 40}}
    good = {"rank": 0, "bf16": {"mode_err": 1e-2, "mode_where": "w", "pure_dp_err": 1e-2,
                                "pure_dp_where": "w", "bytes_by_op": {"all-reduce": 8},
                                "count_by_op": {"all-reduce": 1}, "peak": 100}}
    assert SS.check_witness([good], dry, on_cuda=True) == []
    far = {**good, "bf16": {**good["bf16"], "mode_err": 1e-2 * SS.WITNESS_RATIO * 1.01}}
    counts = {**good, "bf16": {**good["bf16"], "count_by_op": {"all-reduce": 2}}}
    peak = {**good, "bf16": {**good["bf16"], "peak": 120}}
    for bad in (far, counts, peak):
        assert len(SS.check_witness([bad], dry, on_cuda=True)) == 1
