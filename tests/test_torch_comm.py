"""The port's data-parallel S-SGD step on a 2-process gloo group (CPU),
for each measured arch (qwen1.5-4b; recurrentgemma-2b, whose tied embedding
is one leaf with two uses and is all-reduced once; rwkv6-1.6b, whose ``W``
blocks carry float32 leaves beside the bf16 ones at full width).

Two ranks (separate processes, a ``file://`` rendezvous) each take their
half of a global batch and run one step of
``repro_torch.comm.ddp.make_ddp_train_step`` under ``at_end``, ``wfbp``
and ``bucketed`` from the same parameters, which the reference
initialised.  Checked here:

* the three policies give the same parameters (the property
  ``tests/test_comm.py`` pins for the reference);
* those parameters equal one single-process reference SGD step on the
  global batch (float32; 1e-6 absolute -- the step is lr * momentum
  * gradient with gradients that agree to ~1e-7);
* the bytes counted at ``all_reduce`` equal the port's
  ``expected_collective_bytes``, which equals the reference's for every
  policy, and the number of all-reduces is what each schedule issues;
* the bucket partition follows the reference's leaf order and rule, and
  ``grad_payload_bytes`` equals the reference's.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import sync as jsync
from repro.configs import get_config as jax_get_config
from repro.measure import calibrate as jcal
from repro.models import transformer as JT
from repro.optim.sgd import sgd as jax_sgd
from repro_torch.comm import sync as tsync
from repro_torch.configs import get_config as torch_get_config
from repro_torch.measure import calibrate as tcal
from repro_torch.models import transformer as TT

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCHS = ("qwen1.5-4b", "recurrentgemma-2b", "rwkv6-1.6b")
#: one whole layer pattern at least: recurrentgemma's RRL needs 3 layers
REDUCED = {"qwen1.5-4b": dict(num_layers=2), "recurrentgemma-2b": dict(num_layers=3),
           "rwkv6-1.6b": dict(num_layers=2)}
POLICIES = ("at_end", "wfbp", "bucketed")
BUCKET_BYTES = 2e5          # several buckets at the reduced size
LR, MOMENTUM = 0.1, 0.9
PER_RANK, SEQ = 2, 16

WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.comm.ddp import make_ddp_train_step
    from repro_torch.comm.sync import Comm
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.optim.sgd import sgd

    rank, world, init_file, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    spec = json.loads(open(f"{work}/spec.json").read())
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    cfg = get_config(spec["arch"]).reduced(**spec["reduced"])
    arrays = np.load(f"{work}/params.npz")
    tree = {}
    for key in arrays.files:
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = arrays[key]
    data = np.load(f"{work}/batch.npz")
    shard = slice(rank * spec["per_rank"], (rank + 1) * spec["per_rank"])
    batch = {"tokens": torch.from_numpy(data["tokens"][shard]).long(),
             "labels": torch.from_numpy(data["labels"][shard]).long()}
    report = {}
    for pol in spec["policies"]:
        comm = Comm()
        opt = sgd(lr=spec["lr"], momentum=spec["momentum"])
        params = T.from_reference(tree)
        state = opt.init(params)
        step = make_ddp_train_step(cfg, opt, comm, sync_policy=pol,
                                   bucket_bytes=spec["bucket_bytes"])
        params, state, metrics = step(params, state, batch)
        report[pol] = {"bytes": comm.bytes, "calls": comm.calls,
                       "loss": float(metrics["loss"]),
                       "total_loss": float(metrics["total_loss"])}
        if rank == 0:
            np.savez(f"{work}/out_{pol}.npz", **{
                "/".join(p): leaf.float().numpy() for p, leaf in T.leaf_order(params)})
    if rank == 0:
        open(f"{work}/report.json", "w").write(json.dumps(report))
    dist.destroy_process_group()
""")


def _key_path(path) -> tuple:
    return tuple(getattr(k, "key", k) for k in path)


def _flat(tree) -> dict[str, np.ndarray]:
    return {"/".join(_key_path(p)): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _cfgs(arch):
    return (jax_get_config(arch).reduced(**REDUCED[arch]),
            torch_get_config(arch).reduced(**REDUCED[arch]))


@pytest.fixture(scope="module", params=ARCHS)
def dp_run(request, tmp_path_factory):
    """Run the 2-rank step once for all policies; return the reference's
    step, the port's parameters per policy and the ranks' report."""
    arch = request.param
    work = tmp_path_factory.mktemp("dp")
    jcfg, _ = _cfgs(arch)
    params = JT.init_lm(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (2 * PER_RANK, SEQ)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (2 * PER_RANK, SEQ)).astype(np.int32)
    np.savez(work / "params.npz", **_flat(params))
    np.savez(work / "batch.npz", tokens=tokens, labels=labels)
    (work / "spec.json").write_text(json.dumps(dict(
        arch=arch, reduced=REDUCED[arch], policies=POLICIES, bucket_bytes=BUCKET_BYTES,
        lr=LR, momentum=MOMENTUM, per_rank=PER_RANK)))
    script = work / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2",
                               str(work / "rendezvous"), str(work)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append(err)
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-3000:] for e in errs)

    # the reference: one single-process SGD step on the global batch
    def loss(p):
        return JT.loss_fn(jcfg, p, jnp.asarray(tokens), jnp.asarray(labels))[0]

    jloss, grads = jax.value_and_grad(loss)(params)
    opt = jax_sgd(LR, MOMENTUM)
    want, _ = opt.update(grads, opt.init(params), params)
    got = {pol: dict(np.load(work / f"out_{pol}.npz")) for pol in POLICIES}
    report = json.loads((work / "report.json").read_text())
    return dict(arch=arch, want=_flat(want), loss=float(jloss), got=got, report=report,
                params=params)


def _max_diff(a: dict, b: dict) -> float:
    assert a.keys() == b.keys()
    return max(float(np.abs(np.asarray(a[k], np.float32) - np.asarray(b[k], np.float32)).max())
               for k in a)


@pytest.mark.parametrize("policy", ["wfbp", "bucketed"])
def test_policies_give_the_same_parameters(dp_run, policy):
    assert _max_diff(dp_run["got"]["at_end"], dp_run["got"][policy]) < 1e-6


@pytest.mark.parametrize("policy", POLICIES)
def test_parameters_equal_reference_sgd_step_on_global_batch(dp_run, policy):
    assert _max_diff(dp_run["got"][policy], dp_run["want"]) < 1e-6


@pytest.mark.parametrize("policy", POLICIES)
def test_reported_loss_is_global_mean(dp_run, policy):
    r = dp_run["report"][policy]
    assert r["loss"] == pytest.approx(dp_run["loss"], rel=1e-5)
    assert r["total_loss"] == pytest.approx(dp_run["loss"], rel=1e-5)


@pytest.mark.parametrize("policy", POLICIES)
def test_counted_bytes_equal_expected_and_reference(dp_run, policy):
    jcfg, tcfg = _cfgs(dp_run["arch"])
    expected = tcal.expected_collective_bytes(tcfg, policy)
    assert expected == jcal.expected_collective_bytes(jcfg, policy)
    assert dp_run["report"][policy]["bytes"] == expected


def test_all_reduce_calls_follow_each_schedule(dp_run):
    """at_end: one per leaf; wfbp: one per unscanned leaf and per unit
    slice of each stacked leaf; bucketed: one per bucket; plus the two
    metric means.  A tied embedding is one leaf: one all-reduce of the sum
    of its two uses' gradients."""
    _, tcfg = _cfgs(dp_run["arch"])
    leaves = list(TT.leaf_order(TT.init_lm(tcfg, device="meta")))
    n_units = sum(1 for p, _ in leaves if p[0] == "units")
    n_buckets = len(tsync.bucket_partition([leaf for _, leaf in leaves], BUCKET_BYTES))
    calls = {pol: dp_run["report"][pol]["calls"] for pol in POLICIES}
    assert n_buckets > 1
    assert calls == {"at_end": len(leaves) + 2,
                     "wfbp": len(leaves) - n_units + n_units * tcfg.num_units + 2,
                     "bucketed": n_buckets + 2}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bucket_bytes", [1e4, BUCKET_BYTES, tsync.DEFAULT_BUCKET_BYTES])
def test_bucket_partition_follows_reference_leaf_order(bucket_bytes, arch):
    """The reference's rule (``repro.comm.sync.bucketed_pmean``) over its
    flattened leaves, against the port's partition of its leaf order."""
    jcfg, tcfg = _cfgs(arch)
    jleaves = jax.tree_util.tree_leaves(
        jax.eval_shape(lambda k: JT.init_lm(jcfg, k), jax.random.PRNGKey(0)))
    want: list[list[int]] = [[]]
    size = 0.0
    for i, leaf in enumerate(jleaves):
        want[-1].append(i)
        size += leaf.size * leaf.dtype.itemsize
        if size >= bucket_bytes:
            want.append([])
            size = 0.0
    if not want[-1]:
        want.pop()
    tleaves = [leaf for _, leaf in TT.leaf_order(TT.init_lm(tcfg, device="meta"))]
    assert tsync.bucket_partition(tleaves, bucket_bytes) == want


def test_default_bucket_bytes_is_the_reference_constant():
    assert tsync.DEFAULT_BUCKET_BYTES == jsync.DEFAULT_BUCKET_BYTES


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full_width", [False, True])
def test_grad_payload_bytes_equal_reference(full_width, arch):
    if full_width:
        import dataclasses
        depth = REDUCED[arch]["num_layers"]
        jcfg = dataclasses.replace(jax_get_config(arch), num_layers=depth)
        tcfg = dataclasses.replace(torch_get_config(arch), num_layers=depth)
    else:
        jcfg, tcfg = _cfgs(arch)
    assert tcal.grad_payload_bytes(tcfg) == jcal.grad_payload_bytes(jcfg)
    for pol in POLICIES:
        assert tcal.expected_collective_bytes(tcfg, pol) == \
            jcal.expected_collective_bytes(jcfg, pol)


def test_sync_needs_a_group_and_a_known_policy():
    from repro_torch.comm.ddp import make_ddp_train_step
    from repro_torch.optim.sgd import sgd

    _, cfg = _cfgs("qwen1.5-4b")
    with pytest.raises(ValueError, match="process group"):
        make_ddp_train_step(cfg, sgd(0.1), None, sync_policy="wfbp")
    with pytest.raises(ValueError, match="unknown sync policy"):
        make_ddp_train_step(cfg, sgd(0.1), None, sync_policy="ring")
    with pytest.raises(ValueError, match="unknown sync policy"):
        tcal.expected_collective_bytes(cfg, "none")


@pytest.mark.parametrize("arch", ARCHS)
def test_single_process_step_without_sync_equals_reference(arch):
    """``none`` on one process: the step is the reference's SGD step."""
    from repro_torch.comm.ddp import make_ddp_train_step
    from repro_torch.optim.sgd import sgd

    jcfg, tcfg = _cfgs(arch)
    params = JT.init_lm(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    tokens, labels = (rng.integers(0, jcfg.vocab_size, (2, SEQ)).astype(np.int32)
                      for _ in range(2))
    grads = jax.grad(lambda p: JT.loss_fn(jcfg, p, jnp.asarray(tokens),
                                          jnp.asarray(labels))[0])(params)
    opt = jax_sgd(LR, MOMENTUM)
    want, _ = opt.update(grads, opt.init(params), params)
    topt = sgd(LR, MOMENTUM)
    tparams = TT.from_reference(jax.tree_util.tree_map(np.asarray, params))
    step = make_ddp_train_step(tcfg, topt, None, sync_policy="none")
    got, _, metrics = step(tparams, topt.init(tparams),
                           {"tokens": torch.from_numpy(tokens).long(),
                            "labels": torch.from_numpy(labels).long()})
    assert set(metrics) == {"loss", "total_loss", "grad_norm"}
    got = {"/".join(p): leaf.numpy() for p, leaf in TT.leaf_order(got)}
    assert _max_diff(got, _flat(want)) < 1e-6
