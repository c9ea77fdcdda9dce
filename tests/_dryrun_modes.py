"""The checks shared by ``tests/test_torch_dryrun_zero3.py`` and
``tests/test_torch_dryrun_fsdp2d.py``: one (arch, shape) pair lowered at
one unit of its published widths on meta fake tensors, on one of the
reference's production meshes under a sharded mode, held to a count of its
collectives made from the sharding specs alone (:func:`expected_collectives`).
"""
import dataclasses
import math
from collections import Counter

import torch

from repro_torch import kernels
from repro_torch.comm.sharded import sharded_dim
from repro_torch.configs import SHAPES, dryrun_matrix, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import PRODUCTION_MESHES
from repro_torch.models import attention as A
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as T

MATRIX = dryrun_matrix()


def one_unit(arch: str):
    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=len(cfg.layer_pattern)).validate()


def expected_collectives(cfg, shape, sizes: dict, mode: str, remat: bool = True,
                         accum_steps: int = 1) -> tuple[Counter, Counter]:
    """(calls, bytes) by op of one rank's step, from the specs: each sharded
    leaf all-gathered at each use (a unit's slice once a unit, twice under
    remat in training; the encoder not in decode) and in training its
    cotangent reduce-scattered once a use; in training each leaf's gradient
    all-reduced over the axes it is not split over, once a microbatch; one
    4-byte all-reduce a group for the norm; the MoE aux loss's 2·E means
    once a layer's forward and once its backward where the batch is split;
    the sequence-sharded decode's three all-reduces a ``G`` / ``L`` layer."""
    sc = shd.ShardingConfig(mesh_axes=tuple(sizes), mode=mode)
    gparams = tsteps.init_params(cfg, device="meta")
    specs = shd.param_specs(gparams, sc, sizes=sizes)
    calls, nbytes = Counter(), Counter()
    train = shape.kind == "train"
    micro = accum_steps if train else 1
    groups = set()
    for path, leaf in T.leaf_order(gparams):
        found = sharded_dim(T.get_path(specs, path), sizes)
        full = leaf.numel() * leaf.element_size()
        stacked = "units" in path[:-1]
        uses = cfg.num_units if stacked else 1
        if shape.kind == "decode" and path[0] == "encoder":
            uses = 0
        shard = full // (math.prod(sizes[a] for a in found[1]) if found else 1)
        if found:
            groups.add(found[1])
            again = 2 if remat and stacked and train else 1
            calls["all-gather"] += uses * again * micro
            nbytes["all-gather"] += (full if uses else 0) * again * micro
            if train:
                calls["reduce-scatter"] += uses * micro
                nbytes["reduce-scatter"] += shard * micro
        rest = [a for a in sizes if not found or a not in found[1]]
        if train and math.prod(sizes[a] for a in rest) > 1:
            calls["all-reduce"] += micro
            nbytes["all-reduce"] += shard * micro
    gtokens = tsteps.input_specs(cfg, shape, device="meta")
    lead = gtokens["token" if shape.kind == "decode" else "tokens"]
    bspec = shd.resolve_spec(lead.shape, [["batch"]] + [()] * (lead.dim() - 1), sc, sizes)
    batch_split = math.prod(sizes[a] for a in shd.entry_axes(bspec[0]))
    if train:
        calls["all-reduce"] += len(groups)
        nbytes["all-reduce"] += 4 * len(groups)
        if cfg.num_experts and batch_split > 1:
            n = cfg.num_layers * micro * ((2 if remat else 1) + 1)
            calls["all-reduce"] += n
            nbytes["all-reduce"] += n * 2 * cfg.num_experts * 4
    if shape.kind == "decode":
        cspecs = shd.cache_specs(gtokens["cache"], sc, sizes=sizes)
        seq = {shd.entry_axes(s[-3]) for p, s in T.leaf_order(cspecs) if p[-1] in ("k", "v")}
        if any(math.prod(sizes[a] for a in axes) > 1 for axes in seq):
            layers = sum(k in "GL" for k in cfg.layer_pattern) * cfg.num_units
            batch = shape.global_batch // batch_split
            calls["all-reduce"] += 3 * layers
            nbytes["all-reduce"] += layers * batch * cfg.num_heads * (cfg.head_size + 2) * 4
    return +calls, +nbytes


def check_pair(arch: str, shape_name: str, mesh: str, mode: str, monkeypatch) -> dict:
    """Lower the pair; assert the record against the specs; return it."""
    sizes = PRODUCTION_MESHES[mesh]
    cfg, shape = one_unit(arch), SHAPES[shape_name]
    worlds = []
    seq_sharded = A.decode_attention_seq_sharded

    def spy(q, k_new, v_new, cache, pos, comm, **kw):
        worlds.append(comm.world)
        return seq_sharded(q, k_new, v_new, cache, pos, comm, **kw)

    monkeypatch.setattr(A, "decode_attention_seq_sharded", spy)
    kernels.reset_launches()
    rec = dryrun.dryrun_one(arch, shape_name, mesh=sizes, mode=mode,
                            num_layers=cfg.num_layers)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == mesh and rec["mode"] == mode
    assert rec["n_devices"] == math.prod(sizes.values()) and rec["device"] == "meta"
    assert all(n == 0 for n in kernels.all_launches().values())
    assert not torch.cuda.is_initialized()
    # a rank's arguments: its shards, momentum, rows and cache, by the specs
    sc = shd.ShardingConfig(mesh_axes=tuple(sizes), mode=mode)
    gparams = tsteps.init_params(cfg, device="meta")
    pspecs = shd.param_specs(gparams, sc, sizes=sizes)
    want = dryrun._spec_bytes(gparams, pspecs, sizes)
    if shape.kind == "train":     # the f32 momentum
        want += dryrun._spec_bytes(T.map_leaves(lambda _, t: t.float(), gparams), pspecs, sizes)
    gbatch = tsteps.input_specs(cfg, shape, device="meta")
    bspecs = {k: (shd.cache_specs(v, sc, sizes=sizes) if k == "cache" else
                  shd.resolve_spec(v.shape, [["batch"]] + [()] * (v.dim() - 1), sc, sizes))
              for k, v in gbatch.items()}
    want += dryrun._spec_bytes(gbatch, bspecs, sizes)
    assert rec["memory"]["argument_bytes"] == want
    calls, nbytes = expected_collectives(cfg, shape, sizes, mode)
    col = rec["collectives"]
    assert col["count_by_op"] == dict(calls), (col["count_by_op"], dict(calls))
    assert col["bytes_by_op"] == dict(nbytes), (col["bytes_by_op"], dict(nbytes))
    assert col["total_bytes"] == sum(nbytes.values())
    if shape.kind == "train":
        assert calls["all-gather"] and calls["reduce-scatter"]
    # long_500k's combine over the 16 ranks of the data axis, never the world
    assert set(worlds) <= {sizes["data"]}
    assert bool(worlds) == (shape_name == "long_500k" and any(
        k in "GL" for k in cfg.layer_pattern))
    return rec
