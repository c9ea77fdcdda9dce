"""Logical-axis sharding rules (MaxText-style), as pure functions on shapes.

Counterpart of :mod:`repro.models.sharding`: the same rule table and the
same divisibility-aware resolution, with no device and no mesh object.  A
spec is a tuple with one entry per dim: None (replicated), a mesh axis
name, or a tuple of axis names (a multi-axis logical role keeps its
tuple-ness, as in the reference).  Mesh sizes ({axis: size}) are passed
in, or set for the context with :func:`set_mesh_sizes` as the reference
sets them; :func:`shard_shape` gives a leaf's per-device shape.

Mesh axes: ``("data",)`` for the port's data-parallel meshes
(:func:`repro_torch.launch.mesh.dp_mesh_sizes`), ``("data", "model")``
single pod, ``("pod", "data", "model")`` multi-pod.  Logical roles:

* ``batch``  -> every data-parallel axis (``pod`` + ``data``)
* ``fsdp``   -> ``data`` (parameter sharding; disabled in ``pure_dp``
  mode, where the paper's explicit gradient-sync policies apply)
* ``tensor`` -> ``model`` (heads / mlp / vocab)
* ``expert`` -> ``model`` (expert parallelism for MoE)

The reference's ``constrain`` (``with_sharding_constraint``) and
``named_shardings`` have no counterpart: no tensor is placed by a spec.
:mod:`repro_torch.comm.sharded` cuts each rank's slice of the parameters
by these specs and gathers its ``fsdp`` dims per unit; the dims on
``model`` (``tensor``, ``expert``) stay split, and the blocks compute on
them with the collectives of :mod:`repro_torch.comm.tensor_parallel`.
"""
from __future__ import annotations

import contextvars
import math
from dataclasses import dataclass

from repro_torch.models.transformer import Params, map_leaves

Spec = tuple     # one entry per dim: None | str | tuple[str, ...]
MODES = ("fsdp", "fsdp2d", "zero3", "pure_dp")


@dataclass(frozen=True)
class ShardingConfig:
    mesh_axes: tuple[str, ...]               # axes of the active mesh
    mode: str = "fsdp"                       # "fsdp" | "fsdp2d" | "zero3" | "pure_dp"

    def _axis(self, logical: str):
        if logical == "batch":
            if self.mode == "zero3":
                # batch over the whole mesh: 256-way pure DP
                return tuple(self.mesh_axes)
            return tuple(a for a in self.mesh_axes if a in ("pod", "data")) or None
        if logical == "fsdp":
            if self.mode == "pure_dp":
                return None
            if self.mode in ("fsdp2d", "zero3"):
                # no tensor parallelism: both mesh axes shard parameters
                return tuple(a for a in self.mesh_axes
                             if a in ("data", "model")) or None
            return "data" if "data" in self.mesh_axes else None
        if logical in ("tensor", "expert"):
            if self.mode in ("fsdp2d", "zero3"):
                return None
            return "model" if "model" in self.mesh_axes else None
        if logical == "seq":  # sequence sharding (long-context decode)
            return "data" if "data" in self.mesh_axes else None
        if logical is None:
            return None
        raise KeyError(logical)

    def spec(self, *logical) -> Spec:
        return tuple(self._axis(lg) for lg in logical)

    @property
    def tensor_axis(self) -> str | None:
        """The mesh axis of tensor and expert parallelism: ``model`` in
        ``fsdp`` and ``pure_dp`` where the mesh has one, else None."""
        return self._axis("tensor")

    @property
    def dp_axes(self) -> tuple[str, ...]:
        """Axes over which gradients must be explicitly averaged (pure
        data-parallel replication axes)."""
        if self.mode == "pure_dp":
            return tuple(a for a in self.mesh_axes if a in ("pod", "data"))
        # fsdp: the data axis reduce-scatters automatically through the
        # parameter sharding; only the pod axis is pure replication.
        return tuple(a for a in self.mesh_axes if a == "pod")


# ----------------------------------------------------------------------
# Divisibility-aware spec resolution: candidate lists let a leaf fall back
# (kv_heads in {1, 6, 8, ...} do not divide a 16-way model axis), and any
# dim whose size is not divisible stays replicated.
# ----------------------------------------------------------------------
_MESH_SIZES: contextvars.ContextVar[dict[str, int] | None] = \
    contextvars.ContextVar("mesh_sizes", default=None)


def set_mesh_sizes(sizes: dict[str, int] | None):
    return _MESH_SIZES.set(sizes)


def _mesh_sizes(sizes: dict[str, int] | None) -> dict[str, int]:
    if sizes is not None:
        return sizes
    return _MESH_SIZES.get() or {}


def resolve_spec(shape, dim_candidates, sc: ShardingConfig,
                 sizes: dict[str, int] | None = None) -> Spec:
    """Greedy spec assignment: per dim, the first candidate logical
    axis whose mesh axes (a) exist, (b) divide the dim size, and
    (c) are not already used by another dim of this leaf.  ``sizes``
    defaults to those set with :func:`set_mesh_sizes`."""
    sizes = _mesh_sizes(sizes)
    used: set[str] = set()
    out = []
    for dim, candidates in zip(shape, dim_candidates):
        chosen = None
        for logical in candidates:
            axes = sc._axis(logical)
            if axes is None:
                continue
            was_tuple = isinstance(axes, tuple)
            axes_t = axes if was_tuple else (axes,)
            # progressively drop trailing axes until divisible & unused
            while axes_t:
                prod = 1
                ok = True
                for a in axes_t:
                    if a in used or a not in sizes:
                        ok = False
                        break
                    prod *= sizes[a]
                if ok and dim % prod == 0:
                    break
                axes_t = axes_t[:-1]
            if axes_t:
                chosen = axes_t if was_tuple else axes_t[0]
                used.update(axes_t)
                break
        out.append(chosen)
    return tuple(out)


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (None, an axis, or a tuple of them)."""
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def shard_shape(shape, spec: Spec, sizes: dict[str, int]) -> tuple[int, ...]:
    """The per-device shape of a leaf of ``shape`` laid out by ``spec``:
    each dim divided by the product of its mesh axes' sizes."""
    out = []
    for dim, entry in zip(shape, spec):
        n = math.prod(sizes[a] for a in entry_axes(entry))
        if dim % n:
            raise ValueError(f"dim {dim} does not split {n} ways ({entry})")
        out.append(dim // n)
    return tuple(out)


# ----------------------------------------------------------------------
# Parameter specs by leaf name + rank.  Each dim lists *candidates* in
# preference order (e.g. GQA kv projections prefer the tensor axis on
# kv_heads but fall back to head_dim).
# ----------------------------------------------------------------------
def _leaf_candidates(name: str, ndim: int) -> tuple:
    N = ()                                            # replicated dim
    # Attention projections: shard q-heads when they divide the axis,
    # otherwise replicate the head dims (never shard head_dim: a
    # contraction over a sharded hd turns every attention matmul into a
    # cross-device reduction).
    if ndim == 3 and name == "wq":                   # (d, H, hd)
        return (["fsdp"], ["tensor"], N)
    if ndim == 3 and name in ("wk", "wv"):           # (d, K, hd)
        return (["fsdp"], ["tensor"], N)
    if ndim == 3 and name in ("wi", "wg"):           # MoE experts (E, d, ff)
        # expert-parallel when E divides the axis; otherwise experts
        # are tensor-parallel over their hidden dim
        return (["expert"], ["fsdp"], ["tensor"])
    if ndim == 3 and name == "wo":                   # attn (H,hd,d) / MoE (E,ff,d)
        return (["tensor"], N, ["fsdp"])
    if ndim == 2 and name == "embedding":            # (V, d)
        return (["tensor"], ["fsdp"])
    if ndim == 2 and name == "router":               # (d, E)
        return (["fsdp"], N)
    if ndim == 2 and name in ("wi", "wg", "wk", "wr", "ww", "wq",
                              "w_in_x", "w_in_gate", "w_rgate", "w_igate",
                              "lm_head"):            # (d_in, d_out) column-parallel
        return (["fsdp"], ["tensor"])
    if ndim == 2 and name in ("wv", "wo", "w_out"):  # (d_out, d) row-parallel
        return (["tensor"], ["fsdp"])
    if ndim == 2 and name == "conv_w":               # (kw, W)
        return (N, ["tensor"])
    if ndim == 2 and name == "u":                    # rwkv bonus (H, hd)
        return (["tensor"], N)
    if ndim == 1 and name in ("lam", "conv_b"):      # width-aligned vectors
        return (["tensor"],)
    return tuple(() for _ in range(ndim))            # norms, biases, mu


def _tree_specs(tree: Params, candidates, sc: ShardingConfig, stacked_prefixes,
                sizes) -> Params:
    """A tree of specs: each leaf's by its last key and its rank; leaves
    under a key in ``stacked_prefixes`` carry a leading scan (unit) dim,
    which stays unsharded."""
    def spec_for(path, leaf) -> Spec:
        stacked = any(n in stacked_prefixes for n in path[:-1])
        cands = candidates(path[-1], leaf.ndim - (1 if stacked else 0))
        if stacked:
            cands = ((),) + cands
        return resolve_spec(leaf.shape, cands, sc, sizes)

    return map_leaves(spec_for, tree)


def param_specs(params: Params, sc: ShardingConfig, stacked_prefixes=("units",),
                sizes: dict[str, int] | None = None) -> Params:
    """Spec tree for a parameter tree (any leaves with ``shape`` and
    ``ndim``)."""
    return _tree_specs(params, _leaf_candidates, sc, stacked_prefixes, sizes)


# ----------------------------------------------------------------------
# KV-cache / recurrent-state specs (serve_step).
# ----------------------------------------------------------------------
def _cache_candidates(name: str, ndim: int) -> tuple:
    N = ()
    if name in ("k", "v") and ndim == 4:     # (B, S, K, hd)
        # batch over the data axes; the cache *sequence* dim takes the
        # model axis (or the data axis when batch=1, the 500k shape)
        return (["batch"], ["seq", "tensor"], ["tensor"], ["tensor"])
    if name == "S" and ndim == 4:            # rwkv state (B, H, hd, hd)
        return (["batch"], ["tensor"], N, N)
    if name == "h" and ndim == 2:            # rg-lru state (B, W)
        return (["batch"], ["tensor"])
    if name == "conv" and ndim == 3:         # (B, kw-1, W)
        return (["batch"], N, ["tensor"])
    if name.startswith("x_prev") and ndim == 2:
        return (["batch"], N)
    return tuple(N for _ in range(ndim))


def cache_specs(cache: Params, sc: ShardingConfig, stacked_prefixes=("units",),
                sizes: dict[str, int] | None = None) -> Params:
    """Spec tree for a decode cache (:func:`repro_torch.models.transformer.
    init_cache`)."""
    return _tree_specs(cache, _cache_candidates, sc, stacked_prefixes, sizes)
