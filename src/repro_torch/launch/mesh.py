"""Meshes as axis names and sizes, and the fake process group the dry run's
collectives go to.

Counterpart of :mod:`repro.launch.mesh`.  A mesh here is ``{axis: size}``
(what :mod:`repro_torch.models.sharding` resolves specs against); nothing
is placed on devices.  :func:`production_mesh_sizes` is the reference's
TPU v5e pod layout (``make_production_mesh``), :func:`dp_mesh_sizes` its
``make_dp_mesh``: the port runs data parallelism only, the paper's S-SGD
(:mod:`repro_torch.comm.sync`).  The reference's ``make_cpu_mesh`` and
``activate_mesh`` have no counterpart: no mesh is ever made active.

The reference's ``launch/hostdev.py`` (``XLA_FLAGS`` for N placeholder host
devices) has no counterpart either: :func:`fake_process_group` gives the
dry run a process group of world N in one process (``torch.distributed``'s
``"fake"`` backend), whose collectives return at once and move nothing.
"""
from __future__ import annotations

import contextlib

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
