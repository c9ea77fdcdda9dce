"""The sharded-parameter runtime (``zero3``, ``fsdp2d``) on 4 gloo CPU ranks
of a ``{data: 2, model: 2}`` mesh, against the reference's own sharded step.

The reference (``tests/_sharded_reference.py``, in a subprocess on 4 forced
host devices) jits ``repro.launch.steps.make_train_step`` with the
``in_shardings`` of ``named_shardings`` under ``ShardingConfig(("data",
"model"), mode)`` on ``make_cpu_mesh(2, 2)``; the port's ranks
(``tests/_sharded_jobs.py``) run ``repro_torch.launch.sharded_step.
sharded_train`` from the same ``PRNGKey(0)`` parameters
(``transformer.from_reference``) and batch.  Checked per case: the loss
within 1e-5 relative (the mean of the ranks' losses: each rank's is its
rows'); ``grad_norm`` and every gathered parameter and momentum leaf within
2e-4 of the reference leaf's scale (``_tol`` of ``tests/test_kernels.py``);
each rank's slice equal to the block ``NamedSharding.devices_indices_map``
gives the device at its mesh coordinate; the control, which skips the
division by the world size, beyond the limit; each rank's collectives by
op equal to the dry run's (``repro_torch.launch.dryrun.lower``) of the same
config, mesh and mode.  Under ``zero3`` the prefill logits and 4 decode
steps against the reference's ``forward`` and ``decode_step``.  And the
runner's own comparison with ``pure_dp`` (``sharded_step.compare_steps``
and ``check``).

Reduced widths, float32, 8 x 32 tokens but for rwkv6-1.6b.  qwen2-moe-a2.7b runs at
``d_model`` 200 (heads of 32), which 4 does not divide, so its leaves fall
back to ``(data,)`` and their gradients are all-reduced over ``model``; its
8 experts' aux loss is taken over the whole batch, as the reference's.
rwkv6-1.6b runs at 4 x 80 tokens drawn from seed 4, the draw of
``tests/test_torch_model.py``: at the ``PRNGKey(0)`` parameters its float32
gradient is ill-conditioned, and on other draws the reference's own sharded
step lies up to 7.2e-4 of a leaf's scale from its unsharded step (4 x 32
from seed 1), beyond the limit, while here it lies within 4.2e-6.
``xattn/bk`` (whisper-tiny) has a gradient of 0 in exact arithmetic; its
round-off is held to the largest leaf's scale, as in
``tests/test_torch_encdec.py``.
"""
import pickle
from pathlib import Path

import _sharded_jobs
import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch import sharded_step as SS

SIZES = _sharded_jobs.SIZES
WORLD = 4
TOL = 2e-4
LOSS_RTOL = 1e-5

#: the archs at reduced widths (overrides of ``reduced()``)
ARCHS = {"recurrentgemma-2b": {"num_layers": 3},
         "rwkv6-1.6b": {"num_layers": 2},
         "qwen2-moe-a2.7b": {"num_layers": 2, "num_experts": 8, "d_model": 200,
                             "head_dim": 32},
         "whisper-tiny": {"num_layers": 2}}
#: the global batch: (rows, tokens a row, the seed of its draw) (module docstring)
BATCH = {"recurrentgemma-2b": (8, 32, 0), "rwkv6-1.6b": (4, 80, 4),
         "qwen2-moe-a2.7b": (8, 32, 2), "whisper-tiny": (8, 32, 3)}
#: name -> (arch, mode, accum_steps, remat): every arch under zero3, two
#: under fsdp2d, accumulation and remat on and off between them (the
#: reference's compiles set the file's time: ~60 s)
CASES = {"rg_zero3": ("recurrentgemma-2b", "zero3", 2, True),
         "rwkv_zero3": ("rwkv6-1.6b", "zero3", 1, False),
         "rwkv_fsdp2d": ("rwkv6-1.6b", "fsdp2d", 2, True),
         "moe_zero3": ("qwen2-moe-a2.7b", "zero3", 1, False),
         "moe_fsdp2d": ("qwen2-moe-a2.7b", "fsdp2d", 2, True),
         "whisper_zero3": ("whisper-tiny", "zero3", 1, True)}
SERVE = [name for name, case in CASES.items() if case[1] == "zero3"]
RUNNER = {"kind": "runner", "name": "runner", "arch": "rwkv6-1.6b",
          "reduced": {"num_layers": 1}, "sizes": SIZES, "mode": "fsdp2d",
          "global_batch": 4, "seq_len": 32, "accum_steps": 1, "remat": True}


#: serve-only overrides: an expert's capacity of its whole group, so that a
#: rank's decode, whose group is its own rows, drops no token where the
#: reference's, whose group is the whole batch, drops none (as in
#: ``tests/test_torch_decode.py``)
SERVE_OVER = {"qwen2-moe-a2.7b": {"capacity_factor": 2.0}}


def _case(name: str) -> dict:
    arch, mode, accum, remat = CASES[name]
    return {"name": name, "arch": arch, "reduced": ARCHS[arch], "mode": mode,
            "accum_steps": accum, "remat": remat, "serve": name in SERVE,
            "serve_over": SERVE_OVER.get(arch, {})}


def _batch(arch: str) -> dict:
    cfg = get_config(arch).reduced(**ARCHS[arch])
    rows, seq, seed = BATCH[arch]
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.arch_type == "audio":
        batch["frames"] = rng.standard_normal(
            (rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _pkl(path: Path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _leaf(tree, path: str):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference in its own process, the 4 port ranks beside it once
    it has written the parameters; every case in one spawn."""
    tmp = tmp_path_factory.mktemp("sharded")
    cases = [_case(name) for name in CASES]
    records = _sharded_jobs.run_against_reference(
        tmp, cases, {arch: _batch(arch) for arch in ARCHS}, [RUNNER], WORLD)
    return {"tmp": tmp, "ranks": {job["name"]: ranks
                                  for job, ranks in zip([*cases, RUNNER], records)}}


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
    leaves are split 4 ways or 2 (the fallback), others replicated."""
    ref = _pkl(runs["tmp"] / f"ref_{name}.pkl")
    params = _pkl(runs["tmp"] / f"params_{CASES[name][0]}.pkl")
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
    assert 1 in ways and ways & {2, 4}, ways


@pytest.mark.parametrize("name", list(CASES))
def test_the_control_misses_the_reference(runs, name):
    """Without the division by the world size the momentum is 4x the
    synchronized gradient: beyond the limit."""
    ref = _pkl(runs["tmp"] / f"ref_{name}.pkl")
    with np.load(runs["tmp"] / f"port_{name}.npz") as port:
        worst = max(_scaled(port[f"control/{path}"], _leaf(ref["mom"], path))
                    for path in ref["slices"])
    assert worst > TOL


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_equal_the_dry_run(runs, name):
    arch, mode, accum, remat = CASES[name]
    rec = dryrun.lower(get_config(arch).reduced(**ARCHS[arch]),
                       InputShape(name, BATCH[arch][1], BATCH[arch][0], "train"),
                       mesh=SIZES, mode=mode,
                       remat=remat, accum_steps=accum, device="meta")
    col = rec["collectives"]
    assert col["count_by_op"]["all-gather"] > 0 and col["count_by_op"]["reduce-scatter"] > 0
    for res in runs["ranks"][name]:
        assert res["count_by_op"] == col["count_by_op"]
        assert res["bytes_by_op"] == col["bytes_by_op"]


@pytest.mark.parametrize("name", SERVE)
def test_zero3_prefill_and_decode_match_the_reference(runs, name):
    ref = _pkl(runs["tmp"] / f"serve_{name}.pkl")
    rows = []
    for r in range(WORLD):
        with np.load(runs["tmp"] / f"serve_{name}.rank{r}.npz") as got:
            rows.extend(got["rows"].tolist())
            assert _scaled(got["prefill"], ref["prefill"][got["rows"]]) <= TOL
            for t in range(got["decode"].shape[0]):
                assert _scaled(got["decode"][t], ref["decode"][t][got["rows"]]) <= TOL, t
    assert sorted(rows) == list(range(BATCH[CASES[name][0]][0]))   # split 4 ways


def test_runner_against_pure_dp(runs):
    """``compare_steps`` / ``check``: fsdp2d against pure_dp on the same 4
    ranks, the control beyond the limit, the counts the dry run's."""
    ranks = runs["ranks"]["runner"]
    dry = SS.dry_run(RUNNER)
    assert SS.check(RUNNER, ranks, dry, on_cuda=False) == []
    assert all(r["control_mom_err"] > SS.F32_LIMIT for r in ranks)
    broken = [dict(r, mom_err=1.0) for r in ranks]
    assert SS.check(RUNNER, broken, dry, on_cuda=False)


@pytest.mark.parametrize("dim", [0, 1])
def test_gloo_staging_hands_the_backend_a_copy(dim, monkeypatch):
    """``Comm(gloo_staging=True)`` (a dry run of a gloo step) hands the
    reduce-scatter a copy of its input, as gloo copies it; without it the
    input itself (dim 0) or the one copy that moves the blocks to dim 0."""
    import torch
    import torch.distributed as dist

    from repro_torch.comm.sync import Comm
    from repro_torch.launch.mesh import fake_process_group

    seen = []
    monkeypatch.setattr(dist, "reduce_scatter_tensor",
                        lambda out, full, group=None: seen.append(full))
    with fake_process_group(2):
        full = torch.zeros(4, 6)
        for staged in (False, True):
            out = Comm(gloo_staging=staged).reduce_scatter(full, dim)
            assert out.shape == (4 // 2, 6) if dim == 0 else (4, 6 // 2)
    plain, copied = seen
    assert (plain is full) == (dim == 0)
    assert copied is not full and copied.data_ptr() != plain.data_ptr()
    assert torch.equal(copied, plain)


def test_a_dry_run_of_a_gloo_step_holds_gloo_copy():
    """``lower(gloo=True)``: the same collectives, and at a vocabulary large
    enough that the embedding gradient's reduce-scatter sets the peak, the
    temporaries grow by that whole gradient (the copy gloo makes)."""
    cfg = get_config("rwkv6-1.6b").reduced(num_layers=1, vocab_size=65536)
    shape = InputShape("sharded_step", 32, 8, "train")
    plain, staged = (dryrun.lower(cfg, shape, mesh={"data": 2}, mode="zero3", gloo=gloo)
                     for gloo in (False, True))
    assert staged["collectives"] == plain["collectives"]
    grow = staged["memory"]["temp_bytes"] - plain["memory"]["temp_bytes"]
    assert grow == cfg.vocab_size * cfg.d_model * 4
