"""The checks shared by ``tests/test_torch_dryrun_zero3.py``,
``tests/test_torch_dryrun_fsdp2d.py`` and ``tests/test_torch_dryrun_fsdp.py``:
one (arch, shape) pair lowered at one unit of its published widths on meta
fake tensors, on one of the reference's production meshes under a sharded
mode, held to a count of its collectives made from the sharding specs
alone (:func:`expected_collectives`).
"""
import dataclasses
import math
from collections import Counter

import torch
import torch.distributed as dist

from repro_torch import kernels
from repro_torch.comm.sharded import split_axes, split_dims
from repro_torch.configs import SHAPES, dryrun_matrix, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import PRODUCTION_MESHES, MeshGroups
from repro_torch.models import attention as A
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as T

MATRIX = dryrun_matrix()


def one_unit(arch: str):
    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=len(cfg.layer_pattern)).validate()


def tensor_axis(sizes: dict, mode: str) -> str | None:
    """The axis of tensor and expert parallelism where it has several ranks."""
    axis = shd.ShardingConfig(mesh_axes=tuple(sizes), mode=mode).tensor_axis
    return axis if sizes.get(axis or "", 1) > 1 else None


def expected_collectives(cfg, shape, sizes: dict, mode: str, remat: bool = True,
                         accum_steps: int = 1) -> tuple[Counter, Counter]:
    """(calls, bytes) by op of one rank's step, from the specs: each leaf's
    ``fsdp`` dim all-gathered at each use (a unit's slice once a unit, twice
    under remat in training; the encoder not in decode) and in training its
    cotangent reduce-scattered once a use; in training each leaf's gradient
    all-reduced over the axes it is not split over but the tensor axis, once
    a microbatch; one 4-byte all-reduce a group for the norm; the MoE aux
    loss's 2·E means once a layer's forward and once its backward where the
    batch is split; the sequence-sharded decode's three all-reduces a
    ``G`` / ``L`` / ``C`` layer; and under tensor parallelism the blocks'
    own collectives over ``model`` (:func:`tensor_parallel_collectives`)."""
    sc = shd.ShardingConfig(mesh_axes=tuple(sizes), mode=mode)
    tensor = tensor_axis(sizes, mode)
    summed = [a for a in sizes if a != tensor]
    gparams = tsteps.init_params(cfg, device="meta")
    specs = shd.param_specs(gparams, sc, sizes=sizes)
    calls, nbytes = Counter(), Counter()
    train = shape.kind == "train"
    micro = accum_steps if train else 1
    groups = set()
    for path, leaf in T.leaf_order(gparams):
        spec = T.get_path(specs, path)
        dims = split_dims(spec, sizes)
        full = leaf.numel() * leaf.element_size()
        local = full // math.prod(math.prod(sizes[a] for a in axes) for _, axes in dims)
        on_model = math.prod(sizes[tensor] for _, axes in dims if tensor in axes)
        fsdp = [axes for _, axes in dims if tensor not in axes]
        stacked = "units" in path[:-1]
        uses = cfg.num_units if stacked else 1
        if shape.kind == "decode" and path[0] == "encoder":
            uses = 0
        if dims:
            groups.add(split_axes(spec, sizes))
        if fsdp:
            again = 2 if remat and stacked and train else 1
            calls["all-gather"] += uses * again * micro
            nbytes["all-gather"] += (full // on_model if uses else 0) * again * micro
            if train:
                calls["reduce-scatter"] += uses * micro
                nbytes["reduce-scatter"] += local * micro
        rest = [a for a in summed if a not in split_axes(spec, sizes)]
        if train and math.prod(sizes[a] for a in rest) > 1:
            calls["all-reduce"] += micro
            nbytes["all-reduce"] += local * micro
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
        kv = [s for p, s in T.leaf_order(cspecs) if p[-1] in ("k", "v")]
        seq = {shd.entry_axes(s[-3]) for s in kv}
        if any(math.prod(sizes[a] for a in axes) > 1 for axes in seq):
            hd_split = any(tensor in shd.entry_axes(s[-1]) for s in kv) if tensor else False
            hd = cfg.head_size // (sizes[tensor] if hd_split else 1)
            layers = sum(k in "GLC" for k in cfg.layer_pattern) * cfg.num_units
            batch = shape.global_batch // batch_split
            calls["all-reduce"] += 3 * layers
            nbytes["all-reduce"] += layers * batch * cfg.num_heads * (hd + 2) * 4
    tp_calls, tp_bytes = tensor_parallel_collectives(cfg, shape, sizes, mode, batch_split,
                                                     remat, micro)
    return +(calls + tp_calls), +(nbytes + tp_bytes)


def tensor_parallel_collectives(cfg, shape, sizes: dict, mode: str, batch_split: int,
                                remat: bool = True, micro: int = 1) -> tuple[Counter, Counter]:
    """(calls, bytes) by op of the blocks' own collectives over ``model``
    under tensor parallelism, from the layout: which dims of each block's
    leaves the rules put on ``model``.  Per layer, a split op's forward
    collectives run once a microbatch, twice in a unit under remat in
    training, its backward's once:

    Each sum of partial products (a row-parallel product's all-reduce or
    reduce-scatter, and its backward all-gather) is in the activations'
    dtype.

    * attention with its q heads split: the row-parallel ``wo``'s
      all-reduce (forward); one all-reduce of the cotangents of the input
      (and a cross-attention's encoder states), of whole ``wk`` / ``wv`` a
      rank picks heads from, and of the qkv biases (backward).  In decode
      the q heads (and split kv heads) are all-gathered and ``wo``
      all-reduced; a cache whose head dim is on ``model`` sums the scores
      (B·H·S_local f32) and all-gathers the output's head dim;
    * a dense MLP with its hidden split: one all-reduce forward, one back;
    * an MoE layer with experts or their hidden split, or its shared MLP's
      hidden: one all-reduce forward for each split part, and
      back one of the input's cotangent, one of the combine weights' (G·g·k
      f32) and one of a whole ``wo`` (ff-split experts);
    * an RG-LRU block with its width split: all-gather of u and the
      output's all-reduce forward; the input's all-reduce and u's
      reduce-scatter back;
    * an RWKV time mix with its heads split: v's reduce-scatter and the
      output's all-reduce forward; the five interpolated inputs' all-reduce,
      ``w_bias`` / ``ln_scale``'s (f32) and v's all-gather back; a channel
      mix: the reduce-scatter of the sum and the output's all-gather
      forward; the two inputs' all-reduce and the sum's all-gather back;
    * a vocabulary split over ``model``: the lookup's all-reduce; in
      training the head input's all-reduce back and the cross-entropy's two
      all-reduces (max; sums of exponentials and target logits)."""
    calls, nbytes = Counter(), Counter()
    tensor = tensor_axis(sizes, mode)
    if tensor is None:
        return calls, nbytes
    m = sizes[tensor]
    sc = shd.ShardingConfig(mesh_axes=tuple(sizes), mode=mode)
    gparams = tsteps.init_params(cfg, device="meta")
    specs = shd.param_specs(gparams, sc, sizes=sizes)
    train, decode = shape.kind == "train", shape.kind == "decode"
    B = shape.global_batch // batch_split
    S = 1 if decode else shape.seq_len
    dt = torch.empty((), dtype=cfg.dtype).element_size()
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.head_size
    x = B * S * d * dt
    enc_seq = cfg.encoder_seq if cfg.arch_type == "audio" else cfg.num_image_tokens

    def split(spec, dim) -> bool:
        return tensor in shd.entry_axes(spec[dim])

    def add(op, n, size):
        calls[op] += n
        nbytes[op] += n * size

    kv_cache = {}     # unit block -> (its cache's head dim on model, local sequence)
    if decode:
        gcache = tsteps.input_specs(cfg, shape, device="meta")["cache"]
        cspecs = shd.cache_specs(gcache, sc, sizes=sizes)
        for i, kind in enumerate(cfg.layer_pattern):
            if kind in "GLC":
                spec = cspecs["units"][f"b{i}"]["k"]
                seq = gcache["units"][f"b{i}"]["k"].shape[-3]
                kv_cache[i] = (split(spec, -1),
                               seq // math.prod(sizes[a] for a in shd.entry_axes(spec[-3])))

    def attention(a, fwd, bwd, cross=False, cached=None, x=x):
        heads = split(a["wq"], 1)
        if cached is not None:                  # decode's self-attention
            if heads:
                add("all-gather", 1, B * H * hd * dt)
                if split(a["wk"], 1):
                    add("all-gather", 2, B * K * hd * dt)
                add("all-reduce", 1, x)
            hd_split, seq_local = cached
            if hd_split:
                add("all-reduce", 1, B * H * seq_local * 4)
                add("all-gather", 1, B * H * hd * dt)
            return
        if not heads:
            return
        add("all-reduce", fwd, x)
        copied = x + (B * enc_seq * d * dt if cross else 0)
        if not split(a["wk"], 1):
            copied += 2 * d * K * hd * dt
        if cfg.qkv_bias:
            copied += (H + 2 * K) * hd * dt
        add("all-reduce", bwd, copied)

    def mlp(p, fwd, bwd, x=x) -> bool:
        if split(p["wi"], 1):
            add("all-reduce", fwd, x)
            add("all-reduce", bwd, x)
        return split(p["wi"], 1)

    def moe(p, fwd, bwd):
        E, k = cfg.num_experts, cfg.experts_per_token
        experts = split(p["wi"], 0) or split(p["wi"], 2)
        shared = "shared" in p and split(p["shared"]["wi"], 1)
        if not (experts or shared):
            return False
        add("all-reduce", fwd * (experts + shared), x)
        add("all-reduce", bwd, x)
        if experts:
            tokens = B * S
            g = min(cfg.moe_group_size, tokens * (batch_split if train else 1))
            add("all-reduce", bwd, -(-tokens // g) * g * k * 4)
            if not split(p["wi"], 0):
                add("all-reduce", bwd, E * cfg.moe_d_ff * d * dt)
        return True

    def rglru(p, fwd, bwd):
        if split(p["w_in_x"], 1):
            W = cfg.rnn_size
            add("all-gather", fwd, B * S * W * dt)
            add("all-reduce", fwd, x)
            add("all-reduce", bwd, x)
            add("reduce-scatter", bwd, B * S * W // m * dt)

    def rwkv(tm, cm, fwd, bwd):
        if split(tm["wr"], 1):
            add("reduce-scatter", fwd, x // m)
            add("all-reduce", fwd, x)
            add("all-reduce", bwd, 5 * x)
            add("all-reduce", bwd, 2 * d * 4)
            add("all-gather", bwd, x)
        if split(cm["wk"], 1):
            add("reduce-scatter", fwd, x // m)
            add("all-gather", fwd, x)
            add("all-reduce", bwd, 2 * x)
            add("all-gather", bwd, x)

    lm = specs["decoder"] if cfg.arch_type == "audio" else specs
    fwd = micro * (2 if remat and train else 1)      # one unit, remat'd in training
    bwd = micro if train else 0
    last = None       # the unit's last forward collective: (op, bytes)
    for i, kind in enumerate(cfg.layer_pattern):
        p = T.map_leaves(lambda _, s: s[1:], lm["units"][f"b{i}"])
        if kind == "W":
            rwkv(p["time_mix"], p["channel_mix"], fwd, bwd)
            last = (("all-gather", x) if split(p["channel_mix"]["wk"], 1) else
                    ("all-reduce", x) if split(p["time_mix"]["wr"], 1) else None)
            continue
        if kind == "R":
            rglru(p["rglru"], fwd, bwd)
        else:
            attention(p["attn"], fwd, bwd, cached=kv_cache.get(i))
            if kind == "C":
                attention(p["xattn"], fwd, bwd, cross=True)
        ffn_split = moe(p["moe"], fwd, bwd) if "moe" in p else mlp(p["mlp"], fwd, bwd)
        last = ("all-reduce", x) if ffn_split else None
    if remat and train and last:
        # the recompute stops at the unit's last saved tensor
        # (torch.utils.checkpoint's early stop): its last collective, the
        # block output's, whose result nothing saves, runs once
        add(last[0], -micro, last[1])
    if cfg.arch_type == "audio" and not decode:
        x_enc = B * enc_seq * d * dt
        for layer in specs["encoder"]["layers"]:
            attention(layer["attn"], micro, bwd, x=x_enc)
            mlp(layer["mlp"], micro, bwd, x=x_enc)
    # the vocabulary
    vocab = split(lm["embedding"], 0)
    if vocab:
        add("all-reduce", micro, x)
        if train:
            add("all-reduce", micro, x)                 # the head input's cotangent
            add("all-reduce", micro, B * S * 4)         # the max
            add("all-reduce", micro, 2 * B * S * 4)     # the sums
    return calls, nbytes


def _group_ranks(comm) -> tuple[int, ...]:
    return tuple(dist.get_process_group_ranks(comm.group))


def check_pair(arch: str, shape_name: str, mesh: str, mode: str, monkeypatch) -> dict:
    """Lower the pair; assert the record against the specs; return it."""
    sizes = PRODUCTION_MESHES[mesh]
    cfg, shape = one_unit(arch), SHAPES[shape_name]
    groups = []
    seq_sharded = A.decode_attention_seq_sharded

    def spy(q, k_new, v_new, cache, pos, comm, **kw):
        groups.append(_group_ranks(comm))
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
    if shape.kind == "train" and mode != "pure_dp":
        assert calls["all-gather"] and calls["reduce-scatter"]
    # the sequence-sharded decode's combine: long_500k's over the 16 ranks of
    # data; decode_32k's over the 16 of model where the mode splits the model
    mesh0 = MeshGroups(sizes, 0)
    attends = any(k in "GLC" for k in cfg.layer_pattern)
    if shape_name == "long_500k" and attends:
        assert set(groups) == {tuple(mesh0.ranks(("data",)))}, set(groups)
    elif shape_name == "decode_32k" and attends and tensor_axis(sizes, mode):
        assert set(groups) == {tuple(mesh0.ranks(("model",)))}, set(groups)
    else:
        assert not groups
    return rec
