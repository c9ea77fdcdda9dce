"""Parameters held as shards by the sharding rules, gathered per unit in
the forward pass, their gradients reduce-scattered in the backward pass:
the ``zero3``, ``fsdp2d`` and ``fsdp`` modes of :mod:`repro_torch.models.
sharding`, and ``pure_dp`` on a mesh with a ``model`` axis.

The port's counterpart of what XLA's SPMD partitioner makes of the
reference's ``named_shardings`` in those modes (``repro.launch.dryrun``):

* **The layout** is the rule table's (:func:`repro_torch.models.sharding.
  param_specs`), never a flat split.  A leaf's spec splits some dims over
  ``fsdp`` axes (``(data, model)`` or ``(data,)`` in ``zero3`` and
  ``fsdp2d``; ``data`` in ``fsdp``) and, where the mode has tensor
  parallelism (``fsdp``; ``pure_dp`` on a mesh with ``model``), a dim over
  ``model`` through ``tensor`` or ``expert`` (the embedding: V on
  ``model``, d on ``data``); the leading ``units`` axis never.
  :func:`shard_params` cuts this rank's block of every split dim (the
  slice ``NamedSharding.devices_indices_map`` gives the device at the same
  mesh coordinate); :func:`unshard` gathers them back.  The optimizer
  state takes the parameters' specs, and the optimizers of
  :mod:`repro_torch.optim.sgd` update it elementwise on the shards.
* **The gather** (:class:`repro_torch.comm.tensor_parallel.
  GatherInForward`): an all-gather of the slice along an ``fsdp`` dim over
  that dim's process group, whose backward reduce-scatters (sums) the
  cotangent over the same group.  A dim on the
  tensor axis is not gathered: the blocks compute on it as a slice and
  call their own collectives (:mod:`repro_torch.comm.tensor_parallel`).
* **The hook** (:class:`ShardedHook`), a ``param_hook`` of
  :mod:`repro_torch.models.transformer` and :mod:`repro_torch.models.
  encdec`: each unit's parameters are gathered when the unit runs (again
  in the backward pass under ``remat``, as FSDP does), the unscanned
  leaves at their use.  A tied embedding is gathered once and used twice
  (lookup and head), so its two cotangents sum before its one
  reduce-scatter.  It carries the blocks' :class:`repro_torch.comm.
  tensor_parallel.TensorParallel` (:attr:`ShardedHook.tp`).
* **The division** (:meth:`ShardedHook.finish`).  Each leaf's gradient is
  summed over every mesh axis but the tensor axis: its ``fsdp`` dims' axes
  by the gather's reduce-scatter, the rest by an all-reduce (``pod``;
  ``model`` where a ``zero3`` leaf fell back to ``(data,)``; the whole
  mesh for a replicated leaf); then it is divided by the product of those
  axes' sizes (the world size, less the tensor axis').  Never summed over
  the tensor axis, because there every rank already holds the whole
  gradient of its slice (the rule of :mod:`repro_torch.comm.
  tensor_parallel`), the same on every rank for a replicated leaf.  The
  division is right also where ranks of the summed axes hold the same rows
  (``fsdp2d``, whose batch is split over ``data`` alone; a batch the mesh
  does not divide): the sum counts each distinct row as often as it is
  held, the same number of times for every row, so the copies average out.
  Under ``pure_dp`` (``policy`` set) nothing is split over the batch axes,
  and the sum is the gradient-sync policy's over them
  (:func:`repro_torch.comm.sync.sync_gradients`).
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

from repro_torch.comm.sync import Comm, sync_gradients
from repro_torch.comm.tensor_parallel import GatherInForward, TensorParallel
from repro_torch.launch.mesh import MeshGroups
from repro_torch.models.sharding import entry_axes
from repro_torch.models.transformer import Params, get_path, leaf_order, map_leaves


def split_dims(spec, sizes: dict[str, int]) -> tuple[tuple[int, tuple[str, ...]], ...]:
    """(dim, mesh axes) of every dim of ``spec`` split more than one way;
    empty for a replicated leaf."""
    return tuple((d, entry_axes(e)) for d, e in enumerate(spec)
                 if math.prod(sizes[a] for a in entry_axes(e)) > 1)


def split_axes(spec, sizes: dict[str, int]) -> tuple[str, ...]:
    """The mesh axes ``spec`` splits some dim over, in mesh order."""
    used = {a for _, axes in split_dims(spec, sizes) for a in axes}
    return tuple(a for a in sizes if a in used)


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
        for dim, axes in split_dims(get_path(specs, path), sizes):
            t = _block(t, dim, axes, sizes, coords)
        return t.clone()

    return map_leaves(piece, params)


def unshard(shards: Params, specs: Params, mesh: MeshGroups,
            comm: Comm | None = None) -> Params:
    """The whole leaves of ``shards`` (each rank's :func:`shard_params`),
    gathered over their groups (counted by ``comm`` if given)."""
    comm = comm or Comm()

    def whole(path, t):
        t = t.clone()
        for dim, axes in split_dims(get_path(specs, path), mesh.sizes):
            t = comm.on(mesh.group(axes)).all_gather(t, dim)
        return t

    return map_leaves(whole, shards)


@dataclass
class ShardedHook:
    """``param_hook`` gathering every ``fsdp`` dim of the tree it is given
    (module docstring).  ``specs``: the whole parameters' specs (a unit
    slice's spec drops the leading ``units`` entry).  ``batch_axes``: the
    mesh axes the batch is split over, whose ranks take the MoE aux loss's
    means together (:func:`repro_torch.models.moe.aux_over_batch`).
    ``tensor_axis``: the mesh axis of tensor and expert parallelism
    (:attr:`repro_torch.models.sharding.ShardingConfig.tensor_axis`), None
    in ``zero3`` and ``fsdp2d``.  ``policy``: under ``pure_dp``, the
    gradient-sync policy over the batch axes.  ``divide`` False skips the
    division: a control that must fail any comparison with the replicated
    step."""

    specs: Params
    mesh: MeshGroups
    batch_axes: tuple[str, ...] = ()
    comm: Comm = field(default_factory=Comm)
    divide: bool = True
    tensor_axis: str | None = None
    policy: str | None = None
    _tp: TensorParallel | None = field(default=None, init=False, repr=False)

    @property
    def tp(self) -> TensorParallel | None:
        """The blocks' tensor parallelism; None where the tensor axis is
        absent or of one rank."""
        axis = self.tensor_axis
        if axis is None or self.mesh.sizes.get(axis, 1) == 1:
            return None
        if self._tp is None:
            self._tp = TensorParallel(self.comm.on(self.mesh.group((axis,))),
                                      self.mesh.sizes[axis], self.mesh.coords[axis])
        return self._tp

    def _spec(self, path: tuple, unit: int | None = None):
        spec = get_path(self.specs, path)
        return spec if unit is None else spec[1:]

    def __call__(self, tree: Params, path: tuple, unit: int | None = None) -> Params:
        def gather(sub, leaf):
            for dim, axes in split_dims(self._spec(path + sub, unit), self.mesh.sizes):
                if self.tensor_axis not in axes:
                    leaf = GatherInForward.apply(leaf, self.comm.on(self.mesh.group(axes)),
                                                 dim)
            return leaf

        return map_leaves(gather, tree)

    def batch_comm(self) -> Comm | None:
        """A ``Comm`` over the ranks that split the batch; None if none do."""
        if self.mesh.axes_size(self.batch_axes) == 1:
            return None
        return self.comm.on(self.mesh.group(self.batch_axes))

    def _summed(self) -> tuple[str, ...]:
        """The mesh axes every gradient is summed over: all but the tensor
        axis."""
        return tuple(a for a in self.mesh.sizes if a != self.tensor_axis)

    def finish(self, grads: Params) -> Params:
        """The gradients of the whole step's mean loss, each rank's slice
        (module docstring), written in place."""
        summed = self._summed()
        if self.policy is not None:
            if self.mesh.axes_size(summed) == 1:
                return grads
            return sync_gradients(grads, self.policy, self.comm.on(self.mesh.group(summed)),
                                  mean=self.divide)
        works = []
        for path, g in leaf_order(grads):
            split = split_axes(self._spec(path), self.mesh.sizes)
            rest = tuple(a for a in summed if a not in split)
            if self.mesh.axes_size(rest) > 1:
                works.append(self.comm.on(self.mesh.group(rest)).all_reduce(g, async_op=True))
        for work in works:
            work.wait()
        if self.divide:
            n = self.mesh.axes_size(summed)
            for _, g in leaf_order(grads):
                g.div_(n)
        return grads

    def global_norm(self, grads: Params) -> torch.Tensor:
        """The norm of the whole gradient from this rank's slices: each
        group's sum of squares all-reduced over it once."""
        replicated, by_axes = 0.0, {}
        for path, g in leaf_order(grads):
            axes = split_axes(self._spec(path), self.mesh.sizes)
            sq = g.float().square().sum()
            if not axes:
                replicated = replicated + sq
            else:
                by_axes[axes] = by_axes.get(axes, 0.0) + sq
        for axes, sq in by_axes.items():
            self.comm.on(self.mesh.group(axes)).all_reduce(sq)
        return torch.sqrt(replicated + sum(by_axes.values()))
