"""Shape-only dry run: lower each (arch x input shape x mesh x mode) step on
fake tensors and record its memory, FLOPs and collectives.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b \\
        --shape train_4k [--ranks N | --mesh {16x16,2x16x16}] [--mode pure_dp] \\
        [--policy at_end] [--no-remat] [--accum-steps K] [--out-dir results/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh production] \\
        [--mode fsdp] [--missing-only]

Counterpart of :mod:`repro.launch.dryrun`, which lowers and compiles on 512
placeholder host devices.  Here the port's own step (``make_train_step``,
``make_prefill_step``, ``make_serve_step``) runs once under
``FakeTensorMode`` on the parameters, optimizer state and batch of one rank
(:func:`repro_torch.launch.steps.params_shape`, ``input_specs``): no
storage is allocated, nothing is launched, and every kernel runs through
its own shape function (:class:`repro_torch.kernels.build.Operators`), so
the memory counted is the kernels' (lse, o32, the RG-LRU states, the wkv6
checkpoints, each kernel's scratch), never the (B, H, S, S) scores of the
plain attention.  The fake tensors are on CUDA where this torch has a CUDA
device, and on the meta device elsewhere: autograd records each node's
device stream, and a torch without CUDA has no stream to give for a CUDA
tensor.  Both take the kernel path
(:func:`repro_torch.kernels.build.on_kernel_path`) and count alike.

**Which mesh and mode.** ``pure_dp`` runs on the 1-D ``("data",)`` mesh of
:func:`repro_torch.launch.mesh.dp_mesh_sizes` (the paper's S-SGD,
:mod:`repro_torch.comm.sync`): the reference's rules
(:mod:`repro_torch.models.sharding`) replicate every parameter and split
the batch over the ranks where it divides (else it stays replicated:
``prefill_32k``'s 32 rows on 256 ranks); at N > 1 ranks a train step's
gradients go through :func:`repro_torch.comm.sync.sync_gradients`.
Every mode runs on ``dp<N>`` and on the reference's production meshes
``16x16`` and ``2x16x16`` (``--mesh``; ``--all --mesh production`` lowers
every pair on both), the sharded modes with the sharded-parameter runtime
of :mod:`repro_torch.comm.sharded`: the lowered rank, coordinate 0, holds
its shards of the parameters and momentum by the rules, gathers each
unit's ``fsdp`` dims when it runs and reduce-scatters the gradients.
``fsdp`` (the reference's default) and ``pure_dp`` on a mesh with a
``model`` axis put tensor and expert parallelism on that axis
(:mod:`repro_torch.comm.tensor_parallel`): the rank holds its block of
the heads, hidden, vocabulary, RNN width and experts by the rules, and the
blocks call their own collectives over ``model``; under ``pure_dp`` the
gradients are then synchronized over ``pod`` x ``data`` by ``--policy``.
A rank's batch is the global batch over the product of the mesh axes of
the batch's spec (``zero3`` splits it over the whole mesh where it
divides, the others over ``pod`` and ``data``).  Every collective goes to
a ``"fake"`` process group of the mesh's ranks
(:func:`repro_torch.launch.mesh.fake_process_group`, sub-groups from
:func:`repro_torch.launch.mesh.mesh_groups`).  A decode cache is the
rank's slice by the rules.  Where they shard its sequence axis
(``long_500k``, batch 1: over ``data``; ``decode_32k`` under tensor
parallelism: over ``model``), the serve step runs the sequence-sharded
decode (:func:`repro_torch.models.attention.decode_attention_seq_sharded`)
with a :class:`repro_torch.comm.sync.Comm` on the group of that axis, so
the record's ``collectives`` count its combine: three all-reduces a
sharded layer.

**The record** keeps the reference's keys: ``memory`` (``argument_bytes``:
the rank's parameters, optimizer state, batch and cache, from the
sharding specs and :func:`repro_torch.models.sharding.shard_shape`;
``temp_bytes``: the lowering's peak live bytes less the arguments;
``output_bytes``: the returned tensors that alias no argument;
``generated_code_bytes`` null), ``cost_analysis`` (``flops`` from
:func:`flop_counter` over the whole step, the kernels by their FLOP
formulas, every layer counted: ``while_body_counted_once`` false;
``bytes_accessed`` null), ``collectives`` (the calls and result bytes
handed to :class:`repro_torch.comm.sync.Comm`, by op, in the layout of the
reference's ``CollectiveStats.to_dict()``) and ``analytic``
(:func:`repro_torch.core.archcost.step_cost`); ``compile_s`` is null.
Beside them: ``kernel_calls`` (calls per kernel operator) and ``device``.

The reference's ``launch/hlo.py`` has no counterpart (there is no HLO:
the collectives are counted at ``Comm``), nor its ``donate`` (the port's
optimizer updates in place).  Records go to ``results/dryrun_torch/``
(``<arch>__<shape>__<mesh>.json``, ``__<mode>`` before the suffix for a
mode other than ``pure_dp``), never over the reference's
``results/dryrun/``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
import weakref
from collections import Counter
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.comm import sync as S
from repro_torch.comm.sharded import ShardedHook
from repro_torch.configs import ARCH_IDS, SHAPES, InputShape, dryrun_matrix, get_config
from repro_torch.core import archcost
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import (PRODUCTION_MESHES, dp_mesh_sizes, fake_process_group,
                                     mesh_groups, mesh_label)
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as T
from repro_torch.models.sharding import MODES
from repro_torch.optim.sgd import sgd

ROOT = Path(__file__).resolve().parents[3]
RESULTS_DIR = ROOT / "results" / "dryrun_torch"
POLICIES = ("at_end", "bucketed")


def _addmm_flops(self_shape, a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    (m, k), (_, n) = a_shape, b_shape
    return 2 * m * k * n


def flop_counter() -> FlopCounterMode:
    """``FlopCounterMode`` that counts ``addmm`` with an ``out_dtype`` too
    (the chunked loss's bfloat16 backward, :mod:`repro_torch.models.loss`):
    torch's own ``addmm`` formula takes that positional argument for the
    output's shape and raises."""
    return FlopCounterMode(display=False, custom_mapping={torch.ops.aten.addmm: _addmm_flops})


def lowering_device() -> str:
    """``cuda`` where this torch has a CUDA device, else ``meta`` (module
    docstring)."""
    return "cuda" if torch.cuda.is_available() else "meta"


class Lowering(TorchDispatchMode):
    """Counts, over the operators dispatched under it, the live bytes of
    the storages they create (and their peak) and the calls of each kernel
    operator (``repro_torch::<kernel>``).  Storages it was told of
    (:meth:`own`) are the arguments: never counted, and their views not
    either."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.kernel_calls: Counter = Counter()
        self._seen: dict[int, weakref.ref] = {}

    def own(self, tree, count: bool = False) -> None:
        """Register every tensor storage of ``tree`` not seen yet, its bytes
        counted as live when ``count``, until the storage is freed."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._add(t.untyped_storage(), count)

    def _add(self, st, count: bool) -> None:
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes() if count else 0

        def gone(_, key=key, n=n):
            self.live -= n
            self._seen.pop(key, None)

        self._seen[key] = weakref.ref(st, gone)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        ns, _, name = func._schema.name.partition("::")
        if ns == "repro_torch":
            self.kernel_calls[name] += 1
        out = func(*args, **(kwargs or {}))
        self.own(out, count=True)
        return out


def _storage_ids(tree) -> set[int]:
    return {id(t.untyped_storage()) for t in tree_leaves(tree) if isinstance(t, torch.Tensor)}


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _spec_bytes(tree, specs, sizes) -> int:
    """Per-device bytes of ``tree`` laid out by ``specs``."""
    leaves = [t for _, t in T.leaf_order(tree)]
    spec_leaves = [s for _, s in T.leaf_order(specs)]
    total = 0
    for t, spec in zip(leaves, spec_leaves):
        n = 1
        for d in shd.shard_shape(t.shape, spec, sizes):
            n *= d
        total += n * t.element_size()
    return total


def _seq_axes(cache_specs, sizes) -> tuple[str, ...]:
    """The mesh axes the k / v cache leaves' sequence dim is split over
    (``()`` where it is not): ``data`` or, under tensor parallelism,
    ``model``.  Raises where some leaves are split and others not, or over
    different axes: the sequence-sharded decode takes every ``G``, ``L``
    and ``C`` cache split over one group."""
    found = {path: shd.entry_axes(spec[-3]) for path, spec in T.leaf_order(cache_specs)
             if path[-1] in ("k", "v")}
    split = {a for a in found.values() if math.prod(sizes[x] for x in a) > 1}
    if not split:
        return ()
    if len(split) > 1 or len(set(found.values())) > 1:
        raise NotImplementedError(
            "the rules split the sequence axis of some decode cache leaves and not of "
            f"others, or over different axes ({found}): the sequence-sharded decode "
            "takes every G, L and C cache split over one group")
    return split.pop()


def dryrun_one(arch: str, shape_name: str, *, ranks: int = 1,
               mesh: dict[str, int] | None = None, mode: str = "pure_dp",
               policy: str = "at_end", remat: bool = True, accum_steps: int = 1,
               device: str | None = None, num_layers: int | None = None) -> dict:
    """The record of one lowering (module docstring) on ``mesh`` (``{axis:
    size}``; default the ``dp<ranks>`` mesh).  ``num_layers`` cuts the depth
    (the tests lower one unit); ``device`` defaults to
    :func:`lowering_device`.  Raises ``ValueError`` for an unknown mode
    (:func:`check_mode`)."""
    t_start = time.time()
    sizes = dict(mesh) if mesh is not None else dp_mesh_sizes(ranks)
    check_mode(mode)
    cfg = get_config(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers).validate()
    shape = SHAPES[shape_name]
    device = device or lowering_device()
    world = math.prod(sizes.values())
    record: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_label(sizes),
        "mode": mode, "remat": remat, "accum_steps": accum_steps, "n_devices": world,
        "status": "ok",
        "policy": policy if shape.kind == "train" and world > 1 and mode == "pure_dp" else None,
        "device": device, **({"num_layers": cfg.num_layers} if num_layers is not None else {}),
    }
    try:
        record.update(lower(cfg, shape, mesh=sizes, mode=mode, policy=policy, remat=remat,
                            accum_steps=accum_steps, device=device))
        cost = archcost.step_cost(cfg, shape)
        record["analytic"] = {
            "flops": cost.flops, "hbm_bytes": cost.hbm_bytes,
            "model_flops": cost.model_flops, "n_params": cost.n_params,
            "n_active_params": cost.n_active_params, "param_bytes": cost.param_bytes,
        }
    except Exception as e:  # noqa: BLE001 — record the failure, don't crash the sweep
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()
    record["total_s"] = round(time.time() - t_start, 2)
    return record


def check_mode(mode: str) -> None:
    """Raise ``ValueError`` for a mode the rules do not know; every mode
    runs on every mesh."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")


def lower(cfg, shape: InputShape, *, ranks: int = 1, mesh: dict[str, int] | None = None,
          mode: str = "pure_dp", policy: str = "at_end", remat: bool = True,
          accum_steps: int = 1, device: str | None = None, gloo: bool = False) -> dict:
    """One rank's step for ``cfg`` at ``shape`` on ``mesh`` (default
    ``dp<ranks>``) under ``mode``, lowered at coordinate 0 on fake tensors
    of ``device`` holding that rank's shards: the record's ``lower_s``,
    ``compile_s``, ``memory``, ``cost_analysis``, ``collectives`` and
    ``kernel_calls``.  The step is the train step with SGD (lr 1e-2,
    momentum 0.9), the prefill step or the serve step, by ``shape.kind``;
    it runs with the sharded-parameter runtime
    (:class:`repro_torch.comm.sharded.ShardedHook`) wherever the rules
    split a parameter: every mode but ``pure_dp`` on ``dp<N>``.  A rank's
    batch is the global batch over the product of the mesh axes of the
    batch's spec.  ``gloo``: the step as gloo ranks run it, each
    reduce-scatter's input copied first (:class:`repro_torch.comm.sync.
    Comm`'s ``gloo_staging``); the collectives are the same."""
    if policy not in POLICIES:
        raise ValueError(f"unknown gradient-sync policy {policy!r}; one of {POLICIES}")
    device = device or lowering_device()
    sizes = dict(mesh) if mesh is not None else dp_mesh_sizes(ranks)
    check_mode(mode)
    world = math.prod(sizes.values())
    sc = shd.ShardingConfig(mesh_axes=tuple(sizes), mode=mode)
    # global shapes (meta, no storage) -> specs -> one rank's bytes
    gparams = steps_mod.init_params(cfg, device="meta")
    gbatch = steps_mod.input_specs(cfg, shape, device="meta")
    pspecs = shd.param_specs(gparams, sc, sizes=sizes)
    bspecs = {k: (shd.cache_specs(v, sc, sizes=sizes) if k == "cache" else
                  shd.resolve_spec(v.shape, [["batch"]] + [()] * (v.dim() - 1), sc, sizes))
              for k, v in gbatch.items()}
    arg_bytes = _spec_bytes(gparams, pspecs, sizes) + _spec_bytes(gbatch, bspecs, sizes)
    if shape.kind == "train":   # the f32 momentum has the parameters' specs
        arg_bytes += _spec_bytes(T.map_leaves(lambda _, t: t.float(), gparams), pspecs, sizes)
    seq_axes = _seq_axes(bspecs["cache"], sizes) if shape.kind == "decode" else ()
    batch_axes = shd.entry_axes(bspecs["token" if shape.kind == "decode" else "tokens"][0])
    batch = shape.global_batch // math.prod(sizes[a] for a in batch_axes)

    fake = FakeTensorMode()

    def local(tree, specs):     # this rank's slice of every leaf, by its spec
        with fake:
            return T.map_leaves(lambda path, t: torch.empty(
                shd.shard_shape(t.shape, T.get_path(specs, path), sizes), dtype=t.dtype,
                device=device), tree)

    params = local(gparams, pspecs)
    data = steps_mod.input_specs(cfg, shape, device, fake, batch=batch)
    if shape.kind == "decode":
        data["cache"] = local(gbatch["cache"], bspecs["cache"])
    with fake:
        opt = sgd(lr=1e-2, momentum=0.9)
        opt_state = opt.init(params) if shape.kind == "train" else None
    args = (params, opt_state, data)
    if _bytes(args) != arg_bytes:
        raise AssertionError(f"a rank's arguments hold {_bytes(args)} bytes, the specs "
                             f"say {arg_bytes}")
    if shape.kind == "decode":
        data = {**data, "pos": shape.seq_len - 1}     # the step takes a Python int
    comm = S.Comm(gloo_staging=gloo)
    groups = mesh_groups(sizes, 0)
    hook = None
    if mode != "pure_dp" or sizes.get(sc.tensor_axis, 1) > 1:
        hook = ShardedHook(pspecs, groups, batch_axes, comm, tensor_axis=sc.tensor_axis,
                           policy=policy if mode == "pure_dp" else None)
    lowering = Lowering()
    with fake_process_group(world) if world > 1 else contextlib.nullcontext(), fake:
        lowering.own(args)
        t0 = time.time()
        with flop_counter() as flops, lowering:
            if shape.kind == "train":
                sync = (lambda g: S.sync_gradients(g, policy, comm)) \
                    if world > 1 and hook is None else None
                step = steps_mod.make_train_step(cfg, opt, remat=remat, accum_steps=accum_steps,
                                                 grad_sync=sync, sharded=hook)
                out = step(params, opt_state, data)
            elif shape.kind == "prefill":
                out = steps_mod.make_prefill_step(cfg, sharded=hook)(params, data)
            else:
                seq_axis = comm.on(groups.group(seq_axes)) if seq_axes else None
                out = steps_mod.make_serve_step(cfg, seq_axis=seq_axis, sharded=hook)(
                    params, data)
        lower_s = time.time() - t0
    arg_ids = _storage_ids(args)
    outs = {id(st): st for st in (t.untyped_storage() for t in tree_leaves(out)
                                  if isinstance(t, torch.Tensor))}
    return {
        "lower_s": round(lower_s, 2), "compile_s": None,
        "memory": {"argument_bytes": arg_bytes,
                   "output_bytes": sum(st.nbytes() for key, st in outs.items()
                                       if key not in arg_ids),
                   "temp_bytes": lowering.peak, "generated_code_bytes": None},
        "cost_analysis": {"flops": flops.get_total_flops(), "bytes_accessed": None,
                          "while_body_counted_once": False},
        "collectives": {"total_bytes": comm.bytes, "total_count": comm.calls,
                        "bytes_by_op": dict(sorted(comm.bytes_by_op.items())),
                        "count_by_op": dict(sorted(comm.count_by_op.items()))},
        "kernel_calls": dict(sorted(lowering.kernel_calls.items())),
    }


def result_path(arch: str, shape: str, mesh: str, out_dir: Path,
                mode: str = "pure_dp") -> Path:
    """``<arch>__<shape>__<mesh>.json``, with ``__<mode>`` before the
    suffix for a mode other than ``pure_dp``."""
    return out_dir / f"{arch}__{shape}__{mesh}{'' if mode == 'pure_dp' else '__' + mode}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--ranks", type=int, default=1,
                    help="data-parallel ranks (the mesh dp<N>); default 1, one card")
    ap.add_argument("--mesh", choices=(*PRODUCTION_MESHES, "production"),
                    help="one of the reference's production meshes instead of dp<N>; "
                         "'production' (with --all): both")
    ap.add_argument("--all", action="store_true",
                    help="run the full matrix, each pair in a subprocess")
    ap.add_argument("--missing-only", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--mode", default="pure_dp", choices=MODES)
    ap.add_argument("--policy", default="at_end", choices=POLICIES,
                    help="gradient sync of pure_dp at more than one rank")
    ap.add_argument("--out-dir", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    if args.mesh == "production" and not args.all:
        ap.error("--mesh production runs both meshes: it needs --all")
    meshes = (list(PRODUCTION_MESHES) if args.mesh == "production" else
              [args.mesh] if args.mesh else [mesh_label(dp_mesh_sizes(args.ranks))])
    sizes_of = {label: PRODUCTION_MESHES.get(label) or dp_mesh_sizes(args.ranks)
                for label in meshes}
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        combos = [(a, s, label) for a, s in dryrun_matrix() for label in meshes]
        failures = 0
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src"), *filter(None, [os.environ.get("PYTHONPATH")])]))
        for i, (a, s, label) in enumerate(combos):
            path = result_path(a, s, label, out_dir, args.mode)
            if args.missing_only and path.exists() \
                    and json.loads(path.read_text()).get("status") == "ok":
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
                   "--shape", s, "--mode", args.mode, "--policy", args.policy,
                   "--accum-steps", str(args.accum_steps), "--out-dir", str(out_dir),
                   *(["--mesh", label] if label in PRODUCTION_MESHES
                     else ["--ranks", str(args.ranks)])]
            if args.no_remat:
                cmd.append("--no-remat")
            print(f"[{i + 1}/{len(combos)}] {a} x {s} x {label} ({args.mode})", flush=True)
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=3600, env=env)
            if r.returncode != 0:
                failures += 1
                print(r.stdout[-2000:], r.stderr[-2000:], flush=True)
        print(f"done; {failures} subprocess failures")
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --all)")
    label = meshes[0]
    rec = dryrun_one(args.arch, args.shape, mesh=sizes_of[label], mode=args.mode,
                     policy=args.policy, remat=not args.no_remat,
                     accum_steps=args.accum_steps)
    path = result_path(args.arch, args.shape, label, out_dir, args.mode)
    path.write_text(json.dumps(rec, indent=2))
    print(json.dumps({k: v for k, v in rec.items() if k != "traceback"}, indent=2))
    return 0 if rec["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
