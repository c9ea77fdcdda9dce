"""The reference's side of ``tests/test_torch_sharded.py``, run as a script
on 4 forced host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``):

    python tests/_sharded_reference.py <dir>

``<dir>/cases.json`` lists the cases (``name``, ``arch``, ``reduced``,
``mode``, ``accum_steps``, ``remat``, ``serve``; ``key``, which defaults to
the arch) and ``<dir>/batch_<key>.npz`` their batches.  For each key it
first writes the ``PRNGKey(0)`` parameters of its case's config
(``params_<key>.pkl``, nested dicts and lists of numpy arrays)
and then ``params.done``, so that the port's ranks can start; then for
each case the reference's own sharded step — ``repro.launch.steps.
make_train_step`` under ``jax.jit`` with ``in_shardings`` from
``named_shardings(..., ShardingConfig(("data", "model"), mode),
make_cpu_mesh(2, 2))``, the rules set up as ``repro.launch.dryrun.
dryrun_one`` sets them — writing ``ref_<name>.pkl``: the new parameters and
momentum, the metrics, and for every leaf the block
``NamedSharding.devices_indices_map`` gives each device
``mesh.devices[d, m]`` (``slices[path][2 * d + m]``, a (start, stop) per
dim).  A case with ``serve`` also gets ``serve_<name>.pkl``: the
reference's ``forward`` logits of the batch's tokens and the logits of
``decode_step`` at positions 0-3 from a fresh cache, the config with the
case's ``serve_over``.
"""
import dataclasses
import json
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding

from repro.configs import get_config
from repro.launch import steps
from repro.launch.mesh import activate_mesh, make_cpu_mesh
from repro.models import encdec as ED
from repro.models import sharding as shd
from repro.models import transformer as T
from repro.optim.sgd import sgd

DECODE_TOKENS = 4


def _path(keys) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in keys)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfg(case):
    return get_config(case["arch"]).reduced(**case["reduced"])


def train(case, params, batch, mesh) -> dict:
    cfg = _cfg(case)
    sc = shd.ShardingConfig(mesh_axes=mesh.axis_names, mode=case["mode"])
    shd.set_sharding(sc)
    shd.set_mesh_sizes(dict(zip(mesh.axis_names, mesh.devices.shape)))
    opt = sgd(lr=1e-2, momentum=0.9)
    ostate = opt.init(params)
    pspecs = shd.named_shardings(params, sc, mesh)
    ospecs = shd.named_shardings(ostate, sc, mesh)
    bspecs = {k: NamedSharding(mesh, shd.resolve_spec(v.shape, [["batch"]] + [()] * (v.ndim - 1),
                                                      sc))
              for k, v in batch.items()}
    step = steps.make_train_step(cfg, opt, remat=case["remat"], accum_steps=case["accum_steps"])
    jitted = jax.jit(step, in_shardings=(pspecs, ospecs, bspecs),
                     out_shardings=(pspecs, ospecs, None))
    with activate_mesh(mesh):
        args = jax.device_put((params, ostate, batch), (pspecs, ospecs, bspecs))
        new_params, new_state, metrics = jitted(*args)
    slices = {}
    for keys, sharding in jax.tree_util.tree_flatten_with_path(pspecs)[0]:
        leaf = params
        for k in keys:
            leaf = leaf[getattr(k, "key", getattr(k, "idx", None))]
        index = sharding.devices_indices_map(leaf.shape)
        slices[_path(keys)] = [
            [[s.start or 0, leaf.shape[i] if s.stop is None else s.stop]
             for i, s in enumerate(index[mesh.devices[d, m]])]
            for d in range(2) for m in range(2)]
    shd.set_sharding(None)
    shd.set_mesh_sizes(None)
    return {"params": _np(new_params), "mom": _np(new_state["mom"]),
            "metrics": {k: float(v) for k, v in metrics.items()}, "slices": slices}


def serve(case, params, batch) -> dict:
    cfg = dataclasses.replace(_cfg(case), **case["serve_over"])
    tokens = batch["tokens"]
    B = tokens.shape[0]
    if cfg.arch_type == "audio":
        logits = jax.jit(lambda p, f, t: ED.forward(cfg, p, f, t)[0])(
            params, batch["frames"], tokens)
        enc = jax.jit(lambda p, f: ED.encode(cfg, p, f))(params["encoder"], batch["frames"])
        step = jax.jit(lambda p, c, t, pos: ED.decode_step(cfg, p, c, enc, t, pos))
    else:
        logits = jax.jit(lambda p, t: T.forward(cfg, p, t)[0])(params, tokens)
        step = jax.jit(lambda p, c, t, pos: T.decode_step(cfg, p, c, t, pos))
    cache = T.init_cache(cfg, B, tokens.shape[1])
    decoded = []
    for t in range(DECODE_TOKENS):
        out, cache = step(params, cache, tokens[:, t], jnp.asarray(t, jnp.int32))
        decoded.append(out)
    return {"prefill": np.asarray(logits), "decode": np.asarray(jnp.stack(decoded))}


def main(out: Path) -> None:
    cases = json.loads((out / "cases.json").read_text())
    params = {}
    for case in cases:
        key = case.get("key", case["arch"])
        if key not in params:
            params[key] = jax.jit(lambda k, cfg=_cfg(case): steps.init_params(
                cfg, k))(jax.random.PRNGKey(0))
            with open(out / f"params_{key}.pkl", "wb") as f:
                pickle.dump(_np(params[key]), f)
    (out / "params.done").write_text("")
    mesh = make_cpu_mesh(2, 2)
    for case in cases:
        key = case.get("key", case["arch"])
        with np.load(out / f"batch_{key}.npz") as z:
            batch = {k: jnp.asarray(z[k]) for k in z.files}
        result = train(case, params[key], batch, mesh)
        with open(out / f"ref_{case['name']}.pkl", "wb") as f:
            pickle.dump(result, f)
        if case.get("serve"):
            with open(out / f"serve_{case['name']}.pkl", "wb") as f:
                pickle.dump(serve(case, params[key], batch), f)


if __name__ == "__main__":
    main(Path(sys.argv[1]))
