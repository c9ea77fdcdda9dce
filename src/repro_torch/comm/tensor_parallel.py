"""Tensor and expert parallelism on the ``model`` axis: the ``fsdp`` mode, and
``pure_dp`` on a mesh with a ``model`` axis.

The reference jits its step with ``named_shardings`` and lets XLA's SPMD
partitioner insert every collective the layout implies.  The port has no
partitioner: each block computes on this rank's slices of its weights, as
the rule table lays them out (:func:`repro_torch.models.sharding.
param_specs`; :mod:`repro_torch.comm.sharded` cuts them), and calls the
collectives itself through four Megatron-style operators, each an
``autograd.Function`` counted at :class:`repro_torch.comm.sync.Comm`:

* :func:`copy_to_model`: identity; its backward all-reduces the cotangent.
  A replicated tensor goes through it where this rank uses it in part (a
  column-parallel product, a slice), so that the partial cotangents sum;
* :func:`reduce_from_model`: all-reduce of partial sums (a row-parallel
  product, the vocab-parallel lookup); its backward is the identity;
* :func:`gather_from_model`: the whole of a dim split over ``model``
  (all-gather); its backward takes this rank's block of the cotangent, or
  reduce-scatters it where the cotangent is itself partial
  (``partial_grad``);
* :func:`scatter_to_model`: this rank's block of a sum of partial tensors
  (reduce-scatter); its backward all-gathers.

A row-parallel product (:func:`row_parallel`) sums its partial products
in their own dtype, as the reference's partitioner all-reduces a split
dot's output: in bfloat16 each partial is rounded before the sum, unlike
the one product of the unsplit matmul.  A float32 step agrees with the
unsplit one to ~1e-5 of a leaf's scale; a bfloat16 step is held to the
bfloat16 unsplit step's own distance from a float32 one
(:mod:`repro_torch.launch.sharded_step`).

**The rule the blocks keep.** Every rank ends its backward pass with the
*whole* gradient of its own batch's loss for each of its slices: a leaf
split over ``model`` has the gradient of its block, a leaf replicated over
``model`` the same whole gradient on every ``model`` rank.  So a replicated
path beside a split one (the MoE router and aux loss, rwkv's ``mu`` and
token shift, a whole attention where the heads do not divide ``model``)
never passes through :func:`copy_to_model`, and a replicated leaf that a
rank uses in part (the qkv biases, the kv projections a rank picks heads
from, the MoE ``wo`` an ff-split expert slices, rwkv's ``w_bias`` and
``ln_scale``) does.  The gradients are then summed over the batch axes
alone (:meth:`repro_torch.comm.sharded.ShardedHook.finish`).

:func:`kv_heads` is the GQA head choice of a rank whose q heads are split
while its kv heads are not.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import torch
import torch.distributed as dist

if TYPE_CHECKING:     # comm.sync imports the models, which import this module
    from repro_torch.comm.sync import Comm

#: the mesh axis tensor and expert parallelism run on
MODEL_AXIS = "model"


@dataclass
class TensorParallel:
    """This rank's place on the ``model`` axis: ``comm`` on its group (the
    members in ``model`` coordinate order), the axis' ``size`` and this
    rank's ``index`` on it."""

    comm: Comm
    size: int
    index: int

    def block(self, n: int) -> tuple[int, int]:
        """This rank's [start, stop) of a dim of ``n`` split ``size`` ways."""
        if n % self.size:
            raise ValueError(f"a dim of {n} does not split {self.size} ways")
        part = n // self.size
        return self.index * part, (self.index + 1) * part

    def take(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim`` (a view)."""
        start, stop = self.block(t.shape[dim])
        return t.narrow(dim, start, stop - start)


def model_slice(spec, shape, sizes: dict[str, int], coords: dict[str, int]
                ) -> tuple[int, int, int] | None:
    """(dim, start, stop) of the dim of a leaf of ``shape`` that ``spec``
    splits over ``model`` alone, at the mesh coordinate ``coords``; None
    where no dim is split over ``model`` alone."""
    for d, entry in enumerate(spec):
        if entry in (MODEL_AXIS, (MODEL_AXIS,)) and sizes[MODEL_AXIS] > 1:
            part = shape[d] // sizes[MODEL_AXIS]
            return d, coords[MODEL_AXIS] * part, (coords[MODEL_AXIS] + 1) * part
    return None


def kv_heads(num_heads: int, num_kv: int, size: int, index: int) -> tuple[list[int], int]:
    """(the kv heads, in order, that the q heads of rank ``index`` of
    ``size`` read, the number of q heads on each) for q heads split
    ``size`` ways and kv heads whole: q head h reads kv head ``h // (H /
    K)``.  Where the rank's q heads form whole groups of one kv head each,
    each of those kv heads once; else one kv head a q head, repeated."""
    if num_heads % size or num_heads % num_kv:
        raise ValueError(f"{num_heads} q heads on {num_kv} kv heads do not split {size} ways")
    local, group = num_heads // size, num_heads // num_kv
    read = [h // group for h in range(index * local, (index + 1) * local)]
    distinct = sorted(set(read))
    if all(read.count(k) == local // len(distinct) for k in distinct) \
            and local % len(distinct) == 0:
        return distinct, local // len(distinct)
    return read, 1


def _all_gather(t: torch.Tensor, comm: Comm, dim: int) -> torch.Tensor:
    return comm.all_gather(t, dim % t.dim())


def _reduce_scatter(t: torch.Tensor, comm: Comm, dim: int) -> torch.Tensor:
    return comm.reduce_scatter(t, dim % t.dim())


def _all_reduce(t: torch.Tensor, comm: Comm) -> torch.Tensor:
    out = t.contiguous().clone()
    comm.all_reduce(out)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, *xs):
        ctx.tp = tp
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        like = [g for g in gs if g is not None]
        if len({g.dtype for g in like}) == 1:    # one all-reduce for all of them
            flat = _all_reduce(torch.cat([g.reshape(-1) for g in like]), ctx.tp.comm)
            out, off = [], 0
            for g in like:
                out.append(flat[off:off + g.numel()].view(g.shape))
                off += g.numel()
        else:
            out = [_all_reduce(g, ctx.tp.comm) for g in like]
        it = iter(out)
        return (None, *(None if g is None else next(it) for g in gs))


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, x):
        return _all_reduce(x, tp.comm)

    @staticmethod
    def backward(ctx, g):
        return None, g


class GatherInForward(torch.autograd.Function):
    """All-gather of a slice along ``dim`` over ``comm``'s group; the
    backward reduce-scatters (sums) the cotangent over the same group."""

    @staticmethod
    def forward(ctx, shard, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather(shard, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce_scatter(g, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, x, dim):
        ctx.tp, ctx.dim = tp, dim
        return _all_gather(x, tp.comm, dim)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.tp.take(g, ctx.dim).contiguous(), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, x, dim):
        ctx.tp, ctx.dim = tp, dim
        return _reduce_scatter(x, tp.comm, dim)

    @staticmethod
    def backward(ctx, g):
        return None, _all_gather(g.contiguous(), ctx.tp.comm, ctx.dim), None


def copy_to_model(tp: TensorParallel | None, *xs: torch.Tensor):
    """``xs`` unchanged (one tensor, or a tuple for several); the backward
    sums their cotangents over ``model`` in one all-reduce a dtype.  The
    identity without ``tp``."""
    if tp is not None:
        xs = _Copy.apply(tp, *xs)
    return xs[0] if len(xs) == 1 else tuple(xs)


def reduce_from_model(tp: TensorParallel | None, x: torch.Tensor) -> torch.Tensor:
    """The sum over ``model`` of the partial ``x``; the backward passes the
    (whole) cotangent to every rank's part.  ``x`` itself without ``tp``."""
    return x if tp is None else _Reduce.apply(tp, x)


def gather_from_model(tp: TensorParallel | None, x: torch.Tensor, dim: int,
                      partial_grad: bool = False) -> torch.Tensor:
    """The ``model`` ranks' blocks of ``x`` joined along ``dim``.  The
    backward takes this rank's block of the cotangent, the same on every
    rank; with ``partial_grad`` the cotangent is a partial sum on each rank
    and is reduce-scattered (:class:`GatherInForward`).  ``x`` itself
    without ``tp``."""
    if tp is None:
        return x
    if partial_grad:
        return GatherInForward.apply(x, tp.comm, dim % x.dim())
    return _Gather.apply(tp, x, dim)


def scatter_to_model(tp: TensorParallel | None, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over ``model`` of the
    partial ``x``; the backward all-gathers the cotangent's blocks.  ``x``
    itself without ``tp``."""
    return x if tp is None else _Scatter.apply(tp, x, dim)


def row_parallel(tp: TensorParallel | None, x: torch.Tensor, w: torch.Tensor,
                 scatter_dim: int | None = None) -> torch.Tensor:
    """``x @ w`` for a ``w`` that holds this rank's rows (its input dim split
    over ``model``) and an ``x`` of the matching columns: the sum over
    ``model`` of the ranks' products (:func:`reduce_from_model`), or with
    ``scatter_dim`` this rank's block of it (:func:`scatter_to_model`), in
    the products' dtype.  ``x @ w`` itself without ``tp``."""
    if tp is None:
        return x @ w
    return reduce_from_model(tp, x @ w) if scatter_dim is None else \
        scatter_to_model(tp, x @ w, scatter_dim)


def max_over_model(tp: TensorParallel | None, x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over ``model`` (a new tensor, no
    gradient): the softmax's shift of a split vocabulary or cache."""
    out = x.detach().contiguous().clone()
    if tp is not None:
        tp.comm.all_reduce(out, op=dist.ReduceOp.MAX)
    return out
