"""Meshes as axis names and sizes, and the fake process group the dry run's
collectives go to.

Counterpart of :mod:`repro.launch.mesh`.  A mesh here is ``{axis: size}``
(what :mod:`repro_torch.models.sharding` resolves specs against); nothing
is placed on devices.  :func:`production_mesh_sizes` is the reference's
TPU v5e pod layout (``make_production_mesh``), :func:`dp_mesh_sizes` its
``make_dp_mesh``.  :func:`mesh_groups` lays the ranks of a process group
out on such a mesh, row-major as ``jax.make_mesh`` lays out the
reference's devices, and gives the process group of any subset of its
axes (the sharded-parameter runtime, :mod:`repro_torch.comm.sharded`).
The reference's ``make_cpu_mesh`` and ``activate_mesh`` have no
counterpart: no mesh is ever made active.

The reference's ``launch/hostdev.py`` (``XLA_FLAGS`` for N placeholder host
devices) has no counterpart either: :func:`fake_process_group` gives the
dry run a process group of world N in one process (``torch.distributed``'s
``"fake"`` backend), whose collectives return at once and move nothing.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import torch.distributed as dist


def production_mesh_sizes(multi_pod: bool = False) -> dict[str, int]:
    """One pod = 16 x 16 chips; two pods add a leading ``pod`` axis."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def dp_mesh_sizes(n: int) -> dict[str, int]:
    """The 1-D data-parallel mesh of ``n`` ranks."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one rank, got {n}")
    return {"data": n}


#: the reference's production meshes by label (``--mesh`` of the dry run)
PRODUCTION_MESHES = {"16x16": production_mesh_sizes(False),
                     "2x16x16": production_mesh_sizes(True)}


def mesh_label(sizes: dict[str, int]) -> str:
    """``dp<N>`` for a data-parallel mesh, else the sizes joined by ``x``
    (``16x16``, ``2x16x16``), the reference's labels."""
    if tuple(sizes) == ("data",):
        return f"dp{sizes['data']}"
    return "x".join(str(n) for n in sizes.values())


@contextlib.contextmanager
def fake_process_group(world: int, rank: int = 0):
    """A ``"fake"`` process group of ``world`` ranks as the default group,
    this process its rank ``rank``, destroyed on exit whatever happens.
    Raises if a default group already exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    dist.init_process_group("fake", world_size=world, rank=rank, store=FakeStore())
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@dataclass
class MeshGroups:
    """One rank's place on a ``{axis: size}`` mesh whose ranks are laid out
    row-major (the last axis fastest, as ``jax.make_mesh`` lays out
    ``mesh.devices``): its ``coords``, and for any subset of the axes the
    process group of the ranks that share this rank's other coordinates,
    its members in ascending rank, which is the order of their combined
    index over those axes (the first axis major, as a ``PartitionSpec``
    entry of several axes orders its shards)."""

    sizes: dict[str, int]
    rank: int
    coords: dict[str, int] = field(init=False)
    _groups: dict = field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        world = math.prod(self.sizes.values())
        if not 0 <= self.rank < world:
            raise ValueError(f"rank {self.rank} is not on a mesh of {world} ranks")
        self.coords, rest = {}, self.rank
        for axis in reversed(self.sizes):
            rest, self.coords[axis] = divmod(rest, self.sizes[axis])
        self.coords = {a: self.coords[a] for a in self.sizes}

    @property
    def world(self) -> int:
        return math.prod(self.sizes.values())

    def axes_size(self, axes) -> int:
        return math.prod(self.sizes[a] for a in axes)

    def index(self, axes) -> int:
        """This rank's combined coordinate over ``axes`` (the first major)."""
        i = 0
        for a in axes:
            i = i * self.sizes[a] + self.coords[a]
        return i

    def ranks(self, axes) -> list[int]:
        """The ranks that differ from this one at most on ``axes``."""
        out, stride = [0], 1
        for a in reversed(self.sizes):
            choices = range(self.sizes[a]) if a in axes else (self.coords[a],)
            out = [r + c * stride for c in choices for r in out]
            stride *= self.sizes[a]
        return sorted(out)

    def group(self, axes):
        """The process group over ``axes`` (``dist.new_group`` with local
        synchronization, so only its members take part in making it), made
        once; the default group where it spans every rank.  Raises if the
        default group's world is not the mesh's."""
        axes = tuple(a for a in self.sizes if a in axes)
        if axes not in self._groups:
            if dist.get_world_size() != self.world:
                raise ValueError(f"a mesh of {self.world} ranks on a process group of "
                                 f"{dist.get_world_size()}")
            ranks = self.ranks(axes)
            self._groups[axes] = (dist.group.WORLD if len(ranks) == self.world else
                                  dist.new_group(ranks, use_local_synchronization=True))
        return self._groups[axes]


def mesh_groups(sizes: dict[str, int], rank: int) -> MeshGroups:
    """Rank ``rank``'s coordinates and process groups on the mesh ``sizes``
    (:class:`MeshGroups`)."""
    return MeshGroups(dict(sizes), rank)
