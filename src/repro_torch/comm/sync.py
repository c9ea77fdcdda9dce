"""Gradient synchronization policies on ``torch.distributed``.

Counterpart of :mod:`repro.comm.sync`:

* ``at_end`` (CNTK): every gradient leaf mean-reduced after the whole
  backward pass, one blocking collective phase;
* ``wfbp`` (Caffe-MPI / MXNet / TensorFlow): :class:`PsumInBackward`, an
  identity on the forward pass, is applied to each unit's parameter slice
  inside the unit loop; its backward issues that slice's all-reduce
  (``async_op=True``) the moment the slice's gradient is complete, so the
  all-reduces run while the rest of the backward pass computes.  They are
  waited for, and their means written into the gradients, before the
  update (:meth:`WfbpHook.finish`);
* ``bucketed``: gradients fused into flat f32 buckets closed at
  ``bucket_bytes``, in :func:`repro_torch.models.transformer.leaf_order`
  (the reference's leaf order), one all-reduce per bucket.

Every collective of the port goes through :class:`Comm`, which counts the
bytes of each op's result — the port's counterpart of the reference's HLO
collective-bytes harvest (``launch/hlo.py``, which counts the result type).
A dry run of a step that gloo runs (``gloo_staging``) makes the one copy
that gloo makes and a fake process group does not: gloo reduces a
``reduce_scatter_tensor`` as an all-reduce of a copy of its whole input,
of which it keeps this rank's block.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.models.transformer import Params, get_path, leaf_order, map_leaves

SYNC_POLICIES = ("none", "at_end", "wfbp", "bucketed")

#: Default gradient-bucket fusion threshold in bytes (DDP's 25 MB); a copy
#: of ``repro.comm.sync.DEFAULT_BUCKET_BYTES``.
DEFAULT_BUCKET_BYTES = 25e6


@dataclass
class Comm:
    """A process group plus plain-integer counts, by op (``all-reduce``,
    ``all-gather``, ``reduce-scatter``), of the calls made through it and of
    their results' bytes: the reduced tensor, the gathered tensor, the
    rank's shard.  :meth:`on` gives a ``Comm`` on another group that adds
    to the same counts.  ``gloo_staging``: on a fake process group, copy
    a reduce-scatter's input as gloo does (module docstring); never set on
    a real group, where gloo makes the copy itself."""

    group: object = None
    bytes_by_op: Counter = field(default_factory=Counter)
    count_by_op: Counter = field(default_factory=Counter)
    gloo_staging: bool = False

    @property
    def bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def calls(self) -> int:
        return sum(self.count_by_op.values())

    @property
    def world(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    def on(self, group) -> "Comm":
        return type(self)(group, self.bytes_by_op, self.count_by_op, self.gloo_staging)

    def reset(self) -> None:
        self.bytes_by_op.clear()
        self.count_by_op.clear()

    def _count(self, op: str, result: torch.Tensor) -> None:
        self.bytes_by_op[op] += result.numel() * result.element_size()
        self.count_by_op[op] += 1

    def all_reduce(self, t: torch.Tensor, async_op: bool = False,
                   op=dist.ReduceOp.SUM):
        """Reduce ``t`` in place over the group (a sum unless ``op`` says
        otherwise)."""
        self._count("all-reduce", t)
        return dist.all_reduce(t, op=op, group=self.group, async_op=async_op)

    def all_gather(self, shard: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The group's shards concatenated along ``dim`` in group-rank order
        (a new tensor)."""
        n = self.world
        out = shard.new_empty((n * shard.shape[0], *shard.shape[1:]))
        self._count("all-gather", out)
        dist.all_gather_into_tensor(out, shard.contiguous(), group=self.group)
        if dim == 0:
            return out
        shape = list(shard.shape)
        shape[dim] *= n
        return out.view(n, *shard.shape).movedim(0, dim).reshape(shape)

    def reduce_scatter(self, full: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum of ``full`` over the
        group (a new tensor)."""
        n = self.world
        if full.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split {n} ways")
        shape = list(full.shape)
        shape[dim] //= n
        if dim:     # the blocks along dim made the leading blocks of dim 0
            full = full.unflatten(dim, (n, shape[dim])).movedim(dim, 0).reshape(
                n * shape[0], *shape[1:])
        out = full.new_empty(shape)
        self._count("reduce-scatter", out)
        staged = full.clone() if self.gloo_staging else full
        dist.reduce_scatter_tensor(out, staged.contiguous(), group=self.group)
        return out

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean of ``t`` over the group (a new tensor)."""
        out = t.detach().clone()
        self.all_reduce(out)
        return out / self.world


# ----------------------------------------------------------------------
# WFBP: all-reduce in the backward pass
# ----------------------------------------------------------------------
class PsumInBackward(torch.autograd.Function):
    """Identity forward; the backward starts the cotangent's all-reduce on
    a copy and records it in ``hook`` for :meth:`WfbpHook.finish`.  The
    local cotangent flows on unchanged (autograd must not wait for the
    network), and is overwritten by the mean once the all-reduce is done."""

    @staticmethod
    def forward(ctx, x, hook, path, unit):
        ctx.hook, ctx.path, ctx.unit = hook, path, unit
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        buf = g.detach().clone()
        work = ctx.hook.comm.all_reduce(buf, async_op=True)
        ctx.hook.pending.append((ctx.path, ctx.unit, buf, work))
        return g, None, None, None


@dataclass
class WfbpHook:
    """``param_hook`` for :func:`repro_torch.models.transformer.loss_fn`
    tagging every leaf of the tree it is given with :class:`PsumInBackward`."""

    comm: Comm
    pending: list = field(default_factory=list)

    def __call__(self, tree: Params, path: tuple, unit: int | None = None) -> Params:
        return map_leaves(
            lambda sub, leaf: PsumInBackward.apply(leaf, self, path + sub, unit), tree)

    def finish(self, grads: Params) -> Params:
        """Wait for every all-reduce started in the backward pass and
        write its mean into ``grads`` (``grads[path][unit]`` for a unit
        slice); ``psum / world`` in the gradient's dtype, as the
        reference's ``psum_in_backward``."""
        world = self.comm.world
        for path, unit, buf, work in self.pending:
            work.wait()
            target = get_path(grads, path)
            (target if unit is None else target[unit]).copy_(buf.div_(world))
        self.pending.clear()
        return grads


# ----------------------------------------------------------------------
# at_end and bucketed
# ----------------------------------------------------------------------
def pmean_at_end(grads: Params, comm: Comm, mean: bool = True) -> Params:
    """Mean-reduce every gradient leaf after the backward pass: all
    all-reduces started, then all waited for (one collective phase).
    ``mean`` False leaves the sums."""
    works = [(leaf, comm.all_reduce(leaf, async_op=True)) for _, leaf in leaf_order(grads)]
    world = comm.world if mean else 1
    for leaf, work in works:
        work.wait()
        leaf.div_(world)
    return grads


def bucket_partition(leaves: list[torch.Tensor],
                     bucket_bytes: float = DEFAULT_BUCKET_BYTES) -> list[list[int]]:
    """Leaf indices per bucket: a bucket closes once its leaves reach
    ``bucket_bytes`` in their own dtype (``repro.comm.sync.bucketed_pmean``)."""
    buckets: list[list[int]] = [[]]
    size = 0.0
    for i, leaf in enumerate(leaves):
        buckets[-1].append(i)
        size += leaf.numel() * leaf.element_size()
        if size >= bucket_bytes:
            buckets.append([])
            size = 0.0
    if not buckets[-1]:
        buckets.pop()
    return buckets


def bucketed_pmean(grads: Params, comm: Comm,
                   bucket_bytes: float = DEFAULT_BUCKET_BYTES, mean: bool = True) -> Params:
    """One f32 all-reduce per bucket, then scattered back in each leaf's
    dtype.  ``mean`` False leaves the sums."""
    leaves = [leaf for _, leaf in leaf_order(grads)]
    world = comm.world if mean else 1
    for members in bucket_partition(leaves, bucket_bytes):
        flat = torch.cat([leaves[i].reshape(-1).float() for i in members])
        comm.all_reduce(flat)
        flat.div_(world)
        off = 0
        for i in members:
            n = leaves[i].numel()
            leaves[i].copy_(flat[off:off + n].view(leaves[i].shape))
            off += n
    return grads


def sync_gradients(grads: Params, policy: str, comm: Comm | None,
                   bucket_bytes: float = DEFAULT_BUCKET_BYTES, mean: bool = True) -> Params:
    """Post-backward sync; ``wfbp`` gradients were reduced during the
    backward pass (:class:`WfbpHook`) and pass through.  ``mean`` False
    leaves the sums (a control)."""
    if policy in ("none", "wfbp") or comm is None:
        return grads
    if policy == "at_end":
        return pmean_at_end(grads, comm, mean)
    if policy == "bucketed":
        return bucketed_pmean(grads, comm, bucket_bytes, mean)
    raise ValueError(f"unknown sync policy {policy!r}")
