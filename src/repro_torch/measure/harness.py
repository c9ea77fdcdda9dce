"""Per-layer timing harness over the port's train step.

Counterpart of :mod:`repro.measure.harness`.  Runs in every rank of an
initialized process group (:mod:`repro_torch.measure.run` spawns them)
and harvests what the DAG model needs:

* **step time per sync policy**: one warm-up step, then ``step_iters``
  back-to-back steps, the window closed by ``torch.cuda.synchronize()``;
  the bytes handed to ``all_reduce`` in one step are counted per policy;
* **per-layer forward/backward seconds**, segmented from the loss
  (forward) and its gradient (forward + backward) timed at two unit
  depths on rank 0 alone: the slope is the per-unit cost, the intercept
  the embedding + head + loss (:func:`segment_from_depths`, a copy of the
  reference's);
* **per-payload all-reduce times** (f32) for the alpha-beta fit, and the
  optimizer update time ``t_u``;

and emits a paper-format :class:`~repro_torch.traces.format.Trace`.
Timings keep the reference's min-of-repeats convention.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm.ddp import make_ddp_train_step
from repro_torch.comm.sync import DEFAULT_BUCKET_BYTES, Comm
from repro_torch import kernels
from repro_torch.measure.calibrate import cluster_name, grad_payload_bytes
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.optim.sgd import sgd
from repro_torch.traces.format import LayerRecord, Trace

MEASURED_SYNC_POLICIES = ("at_end", "wfbp", "bucketed")


# ----------------------------------------------------------------------
# Timing primitives
# ----------------------------------------------------------------------
def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timeit(fn: Callable, repeats: int, device: torch.device) -> float:
    """Minimum wall seconds of ``fn()`` after one warm-up call, each call
    closed by a device synchronize.  Minimum, not median: wall-clock noise
    is additive, as in the reference's ``_timeit``."""
    fn()
    _sync(device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return min(times)


# ----------------------------------------------------------------------
# Segmentation (copy of the reference's pure math)
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class SegmentTiming:
    unit_fwd_s: float
    unit_bwd_s: float
    rest_fwd_s: float
    rest_bwd_s: float


def segment_from_depths(units: Sequence[int], fwd_s: Sequence[float],
                        full_s: Sequence[float]) -> SegmentTiming:
    """Least-squares segmentation: slope = per-unit cost, intercept = the
    non-scanned remainder; backward = full - forward; negatives clamp to 0
    (a copy of ``repro.measure.harness.segment_from_depths``)."""
    if len(units) < 2:
        raise ValueError("need at least two scan depths to segment")
    u = np.asarray(units, dtype=np.float64)
    if len(set(units)) < 2:
        raise ValueError("scan depths must be distinct")
    f_slope, f_icpt = np.polyfit(u, np.asarray(fwd_s, dtype=np.float64), 1)
    t_slope, t_icpt = np.polyfit(u, np.asarray(full_s, dtype=np.float64), 1)
    unit_fwd = max(float(f_slope), 0.0)
    rest_fwd = max(float(f_icpt), 0.0)
    return SegmentTiming(
        unit_fwd_s=unit_fwd,
        unit_bwd_s=max(float(t_slope) - unit_fwd, 0.0),
        rest_fwd_s=rest_fwd,
        rest_bwd_s=max(float(t_icpt) - rest_fwd, 0.0),
    )


def _depth_variant(cfg: ModelConfig, n_units: int) -> ModelConfig:
    rem = cfg.num_layers % len(cfg.layer_pattern)
    return dataclasses.replace(
        cfg, name=f"{cfg.name}-u{n_units}",
        num_layers=n_units * len(cfg.layer_pattern) + rem)


def _default_depths(cfg: ModelConfig) -> tuple[int, int]:
    u = cfg.num_units
    if u < 1:
        raise ValueError(
            f"{cfg.name}: segmentation needs at least one scanned unit "
            f"(num_layers {cfg.num_layers} < pattern {cfg.layer_pattern!r})")
    return (u, 2 * u)


# ----------------------------------------------------------------------
# The measurement itself
# ----------------------------------------------------------------------
@dataclass
class MeasuredRun:
    arch: str
    config_name: str
    device: str
    n_devices: int
    batch_per_gpu: int
    seq_len: int
    num_units: int
    depths: tuple[int, int]
    trace: Trace
    segments: SegmentTiming
    policy_times: dict[str, float]        # wall s/iteration per policy
    policy_losses: dict[str, float]       # mean loss of the last timed step
    policy_momentum_norms: dict[str, dict[str, float]]  # per leaf, after the timed steps
    counted_bytes: dict[str, int]         # all-reduce bytes of one step per policy
    t_update_s: float
    allreduce_samples: list[tuple[float, float]]
    unit_grad_bytes: float
    rest_grad_bytes: float
    kernel_launches: dict[str, int]       # summed over ranks
    peak_memory_bytes: int                # rank 0, 0 on the CPU
    elapsed_s: float

    @property
    def total_grad_bytes(self) -> float:
        return self.rest_grad_bytes + self.num_units * self.unit_grad_bytes

    def summary(self) -> dict:
        """JSON-serializable record (everything but the trace body)."""
        return {
            "arch": self.arch, "config": self.config_name, "device": self.device,
            "n_devices": self.n_devices, "batch_per_gpu": self.batch_per_gpu,
            "seq_len": self.seq_len, "num_units": self.num_units,
            "depths": list(self.depths),
            "policy_times_s": self.policy_times,
            "policy_losses": self.policy_losses,
            "policy_momentum_norms": self.policy_momentum_norms,
            "counted_bytes": self.counted_bytes,
            "t_update_s": self.t_update_s,
            "allreduce_samples": [[b, t] for b, t in self.allreduce_samples],
            "unit_grad_bytes": self.unit_grad_bytes,
            "rest_grad_bytes": self.rest_grad_bytes,
            "total_grad_bytes": self.total_grad_bytes,
            "segments": dataclasses.asdict(self.segments),
            "kernel_launches": self.kernel_launches,
            "peak_memory_bytes": self.peak_memory_bytes,
            "elapsed_s": self.elapsed_s,
        }


def make_batch(cfg: ModelConfig, global_batch: int, seq_len: int, seed: int = 0):
    """Random (tokens, labels) of the global batch from a CPU generator, so
    every rank draws the same batch and takes its own shard."""
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (global_batch, seq_len), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (global_batch, seq_len), generator=g)
    return tokens, labels


def _free(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _time_policy_step(cfg, comm, policy, batch, step_iters, bucket_bytes, device):
    """(seconds/iteration, all-reduce bytes of one step, the last step's
    mean loss, the f32 momentum's norm per leaf after the timed steps) for
    one policy.  The momentum sums the synchronized gradients, so it moves
    even where an update is below the resolution of bf16 weights."""
    opt = sgd(lr=1e-2, momentum=0.9)
    step = make_ddp_train_step(cfg, opt, comm, sync_policy=policy,
                               bucket_bytes=bucket_bytes)
    params = T.init_lm(cfg, seed=3, device=device)
    st = opt.init(params)
    comm.reset()
    params, st, m = step(params, st, batch)          # warm-up
    _sync(device)
    counted = comm.bytes
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(step_iters):
        params, st, m = step(params, st, batch)
    loss = float(m["loss"])
    _sync(device)
    elapsed = (time.perf_counter() - t0) / step_iters
    mom_norms = {"/".join(path): float(leaf.norm()) for path, leaf in T.leaf_order(st["mom"])}
    del params, st, m
    _free(device)
    return elapsed, counted, loss, mom_norms


def _time_segments(cfg, depths, tokens, labels, repeats, device) -> SegmentTiming:
    """Loss (forward) and its gradient (forward + backward) at each depth,
    on this process alone."""
    fwd_s, full_s = [], []
    for u in depths:
        cfg_u = _depth_variant(cfg, u)
        params = T.init_lm(cfg_u, seed=2, device=device)
        leaves = [leaf.requires_grad_(True) for _, leaf in T.leaf_order(params)]

        def fwd(c=cfg_u, p=params):
            with torch.no_grad():
                return T.loss_fn(c, p, tokens, labels)[0]

        def full(c=cfg_u, p=params, ls=leaves):
            loss = T.loss_fn(c, p, tokens, labels)[0]
            return torch.autograd.grad(loss, ls)

        fwd_s.append(_timeit(fwd, repeats, device))
        full_s.append(_timeit(full, repeats, device))
        del params, leaves
        _free(device)
    return segment_from_depths(list(depths), fwd_s, full_s)


def _time_allreduce(nbytes: float, repeats: int, device: torch.device) -> float:
    """Seconds of one mean all-reduce of an ``nbytes`` f32 payload (0.0 on
    one rank: no collective is issued, the model's ``n=1`` convention)."""
    world = dist.get_world_size()
    if world <= 1 or nbytes <= 0:
        return 0.0
    buf = torch.ones(max(int(nbytes) // 4, 1), dtype=torch.float32, device=device)

    def run():
        dist.all_reduce(buf)
        buf.div_(world)

    t = _timeit(run, repeats, device)
    del buf
    _free(device)
    return t


def _time_update(cfg, repeats, device) -> float:
    opt = sgd(lr=1e-2, momentum=0.9)
    params = T.init_lm(cfg, seed=2, device=device)
    st = opt.init(params)
    grads = T.map_leaves(lambda _, p: torch.ones_like(p), params)
    t = _timeit(lambda: opt.update(grads, st, params), repeats, device)
    del params, st, grads
    _free(device)
    return t


def measure_model(cfg: ModelConfig, *, device: torch.device, arch: str = "",
                  batch_per_gpu: int = 2, seq_len: int = 32,
                  policies: Sequence[str] = MEASURED_SYNC_POLICIES,
                  depths: tuple[int, int] | None = None,
                  repeats: int = 3, step_iters: int = 5,
                  bucket_bytes: float = DEFAULT_BUCKET_BYTES) -> MeasuredRun:
    """Instrument ``cfg``'s train step in every rank of the default process
    group; every rank returns the same :class:`MeasuredRun` (rank 0's
    timings).  ``batch_per_gpu`` is the per-rank batch."""
    t_start = time.perf_counter()
    rank, world = dist.get_rank(), dist.get_world_size()
    depths = depths or _default_depths(cfg)
    kernels.reset_launches()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    tokens, labels = make_batch(cfg, batch_per_gpu * world, seq_len)
    shard = slice(rank * batch_per_gpu, (rank + 1) * batch_per_gpu)
    tokens, labels = tokens[shard].to(device), labels[shard].to(device)
    batch = {"tokens": tokens, "labels": labels}

    # 1) whole-step wall time + counted all-reduce bytes, per policy
    comm = Comm()
    policy_times: dict[str, float] = {}
    policy_losses: dict[str, float] = {}
    policy_mom: dict[str, dict[str, float]] = {}
    counted: dict[str, int] = {}
    for pol in policies:
        policy_times[pol], counted[pol], policy_losses[pol], policy_mom[pol] = \
            _time_policy_step(cfg, comm, pol, batch, step_iters, bucket_bytes, device)

    # 2) segmentation and 4) t_u on rank 0 alone; the others wait
    segments = t_update = None
    if rank == 0:
        segments = _time_segments(cfg, depths, tokens, labels, repeats, device)
        t_update = _time_update(cfg, repeats, device)
    dist.barrier()

    # 3) gradient payloads + measured all-reduce per distinct payload
    unit_bytes, rest_bytes = grad_payload_bytes(cfg)
    total_bytes = rest_bytes + cfg.num_units * unit_bytes
    samples: list[tuple[float, float]] = []
    comm_of: dict[float, float] = {}
    for nbytes in sorted({unit_bytes, rest_bytes, total_bytes}):
        t = _time_allreduce(nbytes, repeats, device)
        comm_of[nbytes] = t
        if nbytes > 0 and t > 0:
            samples.append((nbytes, t))

    counts = kernels.all_launches()
    launches = torch.tensor(list(counts.values()), dtype=torch.int64)
    dist.all_reduce(launches)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    # rank 0's numbers to every rank
    shared = [(segments, t_update, policy_times)]
    dist.broadcast_object_list(shared, src=0)
    segments, t_update, policy_times = shared[0]

    us = 1e6
    recs = [LayerRecord(0, "embed_head", segments.rest_fwd_s * us,
                        segments.rest_bwd_s * us,
                        comm_of.get(rest_bytes, 0.0) * us, rest_bytes)]
    for i in range(cfg.num_units):
        recs.append(LayerRecord(i + 1, f"unit{i}", segments.unit_fwd_s * us,
                                segments.unit_bwd_s * us,
                                comm_of.get(unit_bytes, 0.0) * us, unit_bytes))
    trace = Trace(
        network=cfg.name,
        cluster=cluster_name(device.type, dist.get_backend(), world),
        iterations=(tuple(recs),),
        batch_per_gpu=batch_per_gpu,
        # int32 tokens + labels per sample position, as the reference
        bytes_per_sample=8.0 * seq_len,
    )
    return MeasuredRun(
        arch=arch or cfg.name, config_name=cfg.name,
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        n_devices=world, batch_per_gpu=batch_per_gpu, seq_len=seq_len,
        num_units=cfg.num_units, depths=tuple(depths), trace=trace,
        segments=segments, policy_times=policy_times, policy_losses=policy_losses,
        policy_momentum_norms=policy_mom,
        counted_bytes=counted,
        t_update_s=t_update, allreduce_samples=samples,
        unit_grad_bytes=unit_bytes, rest_grad_bytes=rest_bytes,
        kernel_launches=dict(zip(counts, (int(x) for x in launches))),
        peak_memory_bytes=int(peak), elapsed_s=time.perf_counter() - t_start)
