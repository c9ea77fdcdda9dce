"""Parameters held as shards by the sharding rules, gathered per unit in
the forward pass, their gradients reduce-scattered in the backward pass:
the ``zero3`` and ``fsdp2d`` modes of :mod:`repro_torch.models.sharding`.

The port's counterpart of what XLA's SPMD partitioner makes of the
reference's ``named_shardings`` in those modes (``repro.launch.dryrun``):

* **The layout** is the rule table's (:func:`repro_torch.models.sharding.
  param_specs`), never a flat split.  In ``zero3`` and ``fsdp2d`` the rules
  map ``tensor`` and ``expert`` to nothing, so a leaf has at most one
  sharded dim, its ``fsdp`` candidate: over ``(data, model)``, or
  ``(data,)`` where the product does not divide it; the leading ``units``
  axis never.  :func:`shard_params` cuts this rank's slice of every leaf
  (the slice ``NamedSharding.devices_indices_map`` gives the device at the
  same mesh coordinate); :func:`unshard` gathers them back.  The optimizer
  state takes the parameters' specs, and the optimizers of
  :mod:`repro_torch.optim.sgd` update it elementwise on the shards.
* **The gather** (:class:`GatherInForward`): an all-gather of the slice
  along its sharded dim over that dim's process group, whose backward
  reduce-scatters (sums) the cotangent over the same group.
* **The hook** (:class:`ShardedHook`), a ``param_hook`` of
  :mod:`repro_torch.models.transformer` and :mod:`repro_torch.models.
  encdec`: each unit's parameters are gathered when the unit runs (again
  in the backward pass under ``remat``, as FSDP does), the unscanned
  leaves at their use.  A tied embedding is gathered once and used twice
  (lookup and head), so its two cotangents sum before its one
  reduce-scatter.  :meth:`ShardedHook.finish` all-reduces each sharded
  leaf's gradient over the mesh axes its dim is not sharded over (``pod``;
  ``model`` where the leaf fell back to ``(data,)``) and each replicated
  leaf's over the whole mesh, then divides every gradient by the world
  size.
  Dividing by the whole world is right also where ranks hold the same
  rows (``fsdp2d``, whose batch is split over ``data`` alone; a batch the
  mesh does not divide): the sum over the world counts each distinct row
  as often as it is held, the same number of times for every row, so the
  copies average out.
* **The norm** (:meth:`ShardedHook.global_norm`): the sum of squares of
  the shards over their groups, each replicated leaf counted once, so the
  ``grad_norm`` metric is the replicated step's.

Every collective goes through one :class:`repro_torch.comm.sync.Comm`,
counted by op.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from repro_torch.comm.sync import Comm
from repro_torch.launch.mesh import MeshGroups
from repro_torch.models.sharding import entry_axes
from repro_torch.models.transformer import Params, get_path, leaf_order, map_leaves


def sharded_dim(spec, sizes: dict[str, int]) -> tuple[int, tuple[str, ...]] | None:
    """(dim, mesh axes) of the one dim of ``spec`` split more than one way;
    None for a replicated leaf.  Raises on a spec that splits two dims
    (tensor parallelism: ``fsdp``, ROADMAP queue 1, item 15)."""
    split = [(d, entry_axes(e)) for d, e in enumerate(spec)
             if math.prod(sizes[a] for a in entry_axes(e)) > 1]
    if len(split) > 1:
        raise NotImplementedError(
            f"spec {spec} splits {len(split)} dims: tensor or expert parallelism, which "
            "the port does not run yet (ROADMAP queue 1, item 15)")
    return split[0] if split else None


def _block(t: torch.Tensor, dim: int, axes: tuple[str, ...], sizes: dict[str, int],
           coords: dict[str, int]) -> torch.Tensor:
    n, i = 1, 0
    for a in axes:
        n, i = n * sizes[a], i * sizes[a] + coords[a]
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def shard_params(params: Params, specs: Params, sizes: dict[str, int],
                 coords: dict[str, int]) -> Params:
    """The slice of every leaf of ``params`` (whole, on any device) that
    the rank at ``coords`` holds under ``specs``, as new tensors."""
    def piece(path, t):
        found = sharded_dim(get_path(specs, path), sizes)
        return (t if found is None else _block(t, *found, sizes, coords)).clone()

    return map_leaves(piece, params)


def unshard(shards: Params, specs: Params, mesh: MeshGroups,
            comm: Comm | None = None) -> Params:
    """The whole leaves of ``shards`` (each rank's :func:`shard_params`),
    gathered over their groups (counted by ``comm`` if given)."""
    comm = comm or Comm()

    def whole(path, t):
        found = sharded_dim(get_path(specs, path), mesh.sizes)
        if found is None:
            return t.clone()
        dim, axes = found
        return comm.on(mesh.group(axes)).all_gather(t, dim)

    return map_leaves(whole, shards)


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


@dataclass
class ShardedHook:
    """``param_hook`` gathering every sharded leaf of the tree it is given
    (module docstring).  ``specs``: the whole parameters' specs (a unit
    slice's spec drops the leading ``units`` entry).  ``batch_axes``: the
    mesh axes the batch is split over, whose ranks take the MoE aux loss's
    means together (:func:`repro_torch.models.moe.aux_over_batch`).
    ``divide`` False skips the division by the world size: a control that
    must fail any comparison with the replicated step."""

    specs: Params
    mesh: MeshGroups
    batch_axes: tuple[str, ...] = ()
    comm: Comm = field(default_factory=Comm)
    divide: bool = True

    def _found(self, path: tuple, unit: int | None = None):
        spec = get_path(self.specs, path)
        return sharded_dim(spec if unit is None else spec[1:], self.mesh.sizes)

    def __call__(self, tree: Params, path: tuple, unit: int | None = None) -> Params:
        def gather(sub, leaf):
            found = self._found(path + sub, unit)
            if found is None:
                return leaf
            dim, axes = found
            return GatherInForward.apply(leaf, self.comm.on(self.mesh.group(axes)), dim)

        return map_leaves(gather, tree)

    def batch_comm(self) -> Comm | None:
        """A ``Comm`` over the ranks that split the batch; None if none do."""
        if self.mesh.axes_size(self.batch_axes) == 1:
            return None
        return self.comm.on(self.mesh.group(self.batch_axes))

    def finish(self, grads: Params) -> Params:
        """The gradients of the whole step's mean loss, each rank's slice
        (module docstring), written in place."""
        works = []
        for path, g in leaf_order(grads):
            found = self._found(path)
            rest = tuple(a for a in self.mesh.sizes if found is None or a not in found[1])
            if self.mesh.axes_size(rest) > 1:
                works.append(self.comm.on(self.mesh.group(rest)).all_reduce(g, async_op=True))
        for work in works:
            work.wait()
        if self.divide:
            for _, g in leaf_order(grads):
                g.div_(self.mesh.world)
        return grads

    def global_norm(self, grads: Params) -> torch.Tensor:
        """The norm of the whole gradient from this rank's slices: each
        group's sum of squares all-reduced over it once."""
        replicated, by_axes = 0.0, {}
        for path, g in leaf_order(grads):
            found = self._found(path)
            sq = g.float().square().sum()
            if found is None:
                replicated = replicated + sq
            else:
                by_axes[found[1]] = by_axes.get(found[1], 0.0) + sq
        for axes, sq in by_axes.items():
            self.comm.on(self.mesh.group(axes)).all_reduce(sq)
        return torch.sqrt(replicated + sum(by_axes.values()))
