"""Shape-only dry run: lower each (arch x input shape x data-parallel mesh)
step on fake tensors and record its memory, FLOPs and collectives.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b \\
        --shape train_4k [--ranks N] [--mode pure_dp] [--policy at_end] \\
        [--no-remat] [--accum-steps K] [--out-dir results/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--missing-only]

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

**Which mesh.** The port runs data parallelism only (the paper's S-SGD,
:mod:`repro_torch.comm.sync`), on the 1-D ``("data",)`` mesh of
:func:`repro_torch.launch.mesh.dp_mesh_sizes`.  There the reference's own
rules (:mod:`repro_torch.models.sharding`, ``pure_dp``) replicate every
parameter and split the batch over the ranks where it divides (else it
stays replicated: ``prefill_32k``'s 32 rows on 256 ranks), so the lowered
program is one rank's.  The reference's 2-D meshes (``16x16``,
``2x16x16``) and its ``fsdp`` / ``fsdp2d`` / ``zero3`` modes need a model
axis (tensor or expert parallelism) or a per-layer parameter gather, which
the port does not run: they raise ``NotImplementedError``.  Where the
rules shard a decode cache's sequence axis (``long_500k``, batch 1, on more
than one rank), a rank's ``G`` and ``L`` cache leaves are its local slices
(sequence length S / N) and the serve step runs the sequence-sharded decode
(:func:`repro_torch.models.attention.decode_attention_seq_sharded`) with a
:class:`repro_torch.comm.sync.Comm` on the fake process group, so the
record's ``collectives`` count its combine: three all-reduces a sharded
layer.  At N > 1 ranks a
train step's gradients go through
:func:`repro_torch.comm.sync.sync_gradients` on a ``"fake"`` process group
of N ranks (:func:`repro_torch.launch.mesh.fake_process_group`).

**The record** keeps the reference's keys: ``memory`` (``argument_bytes``:
the rank's parameters, optimizer state, batch and cache, from the
sharding specs and :func:`repro_torch.models.sharding.shard_shape`;
``temp_bytes``: the lowering's peak live bytes less the arguments;
``output_bytes``: the returned tensors that alias no argument;
``generated_code_bytes`` null), ``cost_analysis`` (``flops`` from
``FlopCounterMode`` over the whole step, the kernels by their FLOP
formulas, every layer counted: ``while_body_counted_once`` false;
``bytes_accessed`` null), ``collectives`` (bytes and calls handed to
:class:`repro_torch.comm.sync.Comm`, in the layout of the reference's
``CollectiveStats.to_dict()``) and ``analytic``
(:func:`repro_torch.core.archcost.step_cost`); ``compile_s`` is null.
Beside them: ``kernel_calls`` (calls per kernel operator) and ``device``.

The reference's ``launch/hlo.py`` has no counterpart (there is no HLO:
the collectives are counted at ``Comm``), nor its ``donate`` (the port's
optimizer updates in place).  Records go to ``results/dryrun_torch/``
(``<arch>__<shape>__dp<N>.json``), never over the reference's
``results/dryrun/``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
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
from repro_torch.configs import ARCH_IDS, SHAPES, InputShape, dryrun_matrix, get_config
from repro_torch.core import archcost
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import dp_mesh_sizes, fake_process_group, mesh_label
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as T
from repro_torch.models.sharding import MODES
from repro_torch.optim.sgd import sgd

ROOT = Path(__file__).resolve().parents[3]
RESULTS_DIR = ROOT / "results" / "dryrun_torch"
POLICIES = ("at_end", "bucketed")


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


def _seq_sharded(cache_specs) -> list[str]:
    """Key paths of the k / v cache leaves whose sequence dim is sharded."""
    return ["/".join(map(str, path)) for path, spec in T.leaf_order(cache_specs)
            if path[-1] in ("k", "v") and spec[-3] is not None]


def dryrun_one(arch: str, shape_name: str, *, ranks: int = 1, mode: str = "pure_dp",
               policy: str = "at_end", remat: bool = True, accum_steps: int = 1,
               device: str | None = None, num_layers: int | None = None) -> dict:
    """The record of one lowering (module docstring).  ``num_layers`` cuts
    the depth (the tests lower one unit); ``device`` defaults to
    :func:`lowering_device`.  Raises ``NotImplementedError`` for a mode the
    port does not run."""
    t_start = time.time()
    check_mode(mode)
    cfg = get_config(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers).validate()
    shape = SHAPES[shape_name]
    device = device or lowering_device()
    record: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_label(dp_mesh_sizes(ranks)),
        "mode": mode, "remat": remat, "accum_steps": accum_steps, "n_devices": ranks,
        "status": "ok", "policy": policy if shape.kind == "train" and ranks > 1 else None,
        "device": device, **({"num_layers": cfg.num_layers} if num_layers is not None else {}),
    }
    try:
        record.update(lower(cfg, shape, ranks=ranks, policy=policy, remat=remat,
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
    if mode != "pure_dp":
        raise NotImplementedError(
            f"mode {mode!r} shards parameters or needs a model axis (tensor or expert "
            "parallelism, a per-layer parameter gather); the port runs data parallelism "
            "only: use pure_dp")


def lower(cfg, shape: InputShape, *, ranks: int = 1, policy: str = "at_end",
          remat: bool = True, accum_steps: int = 1, device: str | None = None) -> dict:
    """One rank's step for ``cfg`` at ``shape`` on the ``dp<ranks>`` mesh
    (``pure_dp``), lowered on fake tensors of ``device``: the record's
    ``lower_s``, ``compile_s``, ``memory``, ``cost_analysis``, ``collectives``
    and ``kernel_calls``.  The step is the train step with SGD (lr 1e-2,
    momentum 0.9), the prefill step or the serve step, by ``shape.kind``."""
    if policy not in POLICIES:
        raise ValueError(f"unknown gradient-sync policy {policy!r}; one of {POLICIES}")
    device = device or lowering_device()
    sizes = dp_mesh_sizes(ranks)
    sc = shd.ShardingConfig(mesh_axes=tuple(sizes), mode="pure_dp")
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
    sharded = _seq_sharded(bspecs["cache"]) if shape.kind == "decode" else []
    kv_leaves = [p for p, _ in T.leaf_order(gbatch.get("cache", {})) if p[-1] in ("k", "v")]
    if sharded and len(sharded) != len(kv_leaves):
        raise NotImplementedError(
            f"the rules shard the sequence axis of some decode cache leaves over {ranks} "
            f"ranks ({', '.join(sharded)}) and not of others: the sequence-sharded decode "
            "takes every G and L cache sharded")
    lead = bspecs["token" if shape.kind == "decode" else "tokens"][0]
    batch = shape.global_batch // (ranks if lead is not None else 1)

    mode = FakeTensorMode()
    params = steps_mod.params_shape(cfg, device, mode)
    data = steps_mod.input_specs(cfg, shape, device, mode, batch=batch)
    if sharded:     # this rank's slice of every cache leaf, by its spec
        with mode:
            data["cache"] = T.map_leaves(
                lambda path, t: torch.empty(
                    shd.shard_shape(t.shape, T.get_path(bspecs["cache"], path), sizes),
                    dtype=t.dtype, device=device), gbatch["cache"])
    with mode:
        opt = sgd(lr=1e-2, momentum=0.9)
        opt_state = opt.init(params) if shape.kind == "train" else None
    args = (params, opt_state, data)
    if _bytes(args) != arg_bytes:
        raise AssertionError(f"a rank's arguments hold {_bytes(args)} bytes, the specs "
                             f"say {arg_bytes}")
    if shape.kind == "decode":
        data = {**data, "pos": shape.seq_len - 1}     # the step takes a Python int
    comm = S.Comm()
    lowering = Lowering()
    with fake_process_group(ranks) if ranks > 1 else contextlib.nullcontext(), mode:
        lowering.own(args)
        t0 = time.time()
        with FlopCounterMode(display=False) as flops, lowering:
            if shape.kind == "train":
                sync = (lambda g: S.sync_gradients(g, policy, comm)) if ranks > 1 else None
                step = steps_mod.make_train_step(cfg, opt, remat=remat,
                                                 accum_steps=accum_steps, grad_sync=sync)
                out = step(params, opt_state, data)
            elif shape.kind == "prefill":
                out = steps_mod.make_prefill_step(cfg)(params, data)
            else:
                out = steps_mod.make_serve_step(cfg, seq_axis=comm if sharded else None)(
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
                        "bytes_by_op": {"all-reduce": comm.bytes} if comm.calls else {},
                        "count_by_op": {"all-reduce": comm.calls} if comm.calls else {}},
        "kernel_calls": dict(sorted(lowering.kernel_calls.items())),
    }


def result_path(arch: str, shape: str, ranks: int, out_dir: Path) -> Path:
    return out_dir / f"{arch}__{shape}__dp{ranks}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--ranks", type=int, default=1,
                    help="data-parallel ranks (the mesh dp<N>); default 1, one card")
    ap.add_argument("--all", action="store_true",
                    help="run the full matrix, each pair in a subprocess")
    ap.add_argument("--missing-only", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--mode", default="pure_dp", choices=MODES)
    ap.add_argument("--policy", default="at_end", choices=POLICIES,
                    help="gradient sync at more than one rank")
    ap.add_argument("--out-dir", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    try:
        check_mode(args.mode)
    except NotImplementedError as e:
        ap.error(f"--mode {args.mode}: {e}")

    if args.all:
        combos = dryrun_matrix()
        failures = 0
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src"), *filter(None, [os.environ.get("PYTHONPATH")])]))
        for i, (a, s) in enumerate(combos):
            path = result_path(a, s, args.ranks, out_dir)
            if args.missing_only and path.exists() \
                    and json.loads(path.read_text()).get("status") == "ok":
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
                   "--shape", s, "--ranks", str(args.ranks), "--mode", args.mode,
                   "--policy", args.policy, "--accum-steps", str(args.accum_steps),
                   "--out-dir", str(out_dir)]
            if args.no_remat:
                cmd.append("--no-remat")
            print(f"[{i + 1}/{len(combos)}] {a} x {s} x dp{args.ranks}", flush=True)
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=3600, env=env)
            if r.returncode != 0:
                failures += 1
                print(r.stdout[-2000:], r.stderr[-2000:], flush=True)
        print(f"done; {failures} subprocess failures")
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --all)")
    rec = dryrun_one(args.arch, args.shape, ranks=args.ranks, mode=args.mode,
                     policy=args.policy, remat=not args.no_remat,
                     accum_steps=args.accum_steps)
    path = result_path(args.arch, args.shape, args.ranks, out_dir)
    path.write_text(json.dumps(rec, indent=2))
    print(json.dumps({k: v for k, v in rec.items() if k != "traceback"}, indent=2))
    return 0 if rec["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
