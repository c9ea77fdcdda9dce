"""Hardware models for the DAG performance model: a copy of
:mod:`repro.core.hardware` (left out, since no port path calls them: the
TPU v5e roofline constants).

The clusters (:data:`CLUSTERS`: the paper's Table II K80+PCIe+10GbE and
V100+NVLink+100Gb InfiniBand, and the reference's TPU v5e pods) and the
interconnect presets are kept verbatim: they are scenario inputs of the
model, which the reference's grids name, not measurements of the card the
port runs on.  The collective models are polymorphic over NumPy and torch
(:mod:`repro_torch.core.xputil`), so the batched engine and its twin on the
card (:mod:`repro_torch.core.batched_torch`) call the same functions.

Units, everywhere in this module: bandwidths are **bytes/second**,
latencies **seconds**, payloads **bytes**, compute rates **flop/s**,
and every function returning a time returns **seconds**.  The comm
cost functions accept NumPy arrays for ``nbytes`` and broadcast
elementwise — this is what the sweep engine's vectorized fast path
relies on (:mod:`repro_torch.core.sweep`).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.xputil import array_namespace, astype, is_tensor

GB = 1e9
MB = 1e6
US = 1e-6

#: All-reduce algorithms understood by :meth:`ClusterSpec.allreduce_time`.
#: ``ring`` is the paper's NCCL baseline; ``tree`` models NCCL's
#: double-binary-tree; ``hierarchical`` is intra-node + inter-node
#: two-level reduction (§VII of the paper calls for exactly this kind
#: of topology-aware collective study).
COLLECTIVE_ALGORITHMS = ("ring", "tree", "hierarchical")


@dataclass(frozen=True)
class Interconnect:
    """A communication channel with an alpha-beta cost model.

    ``transfer_time(n)`` = alpha + n / (B * efficiency), i.e. the
    classic latency/bandwidth model the paper uses for every link
    (PCIe, NVLink, 10GbE, InfiniBand).
    """

    name: str
    bandwidth: float          # bytes / s (peak, per direction)
    latency: float            # seconds per message (alpha term)
    efficiency: float = 1.0   # achieved fraction of peak for collectives

    @property
    def effective_bandwidth(self) -> float:
        """Achieved bytes/s for collectives: ``bandwidth * efficiency``."""
        return self.bandwidth * self.efficiency

    def transfer_time(self, nbytes: float) -> float:
        """Point-to-point transfer time (seconds) for ``nbytes`` bytes."""
        return self.latency + nbytes / self.effective_bandwidth

    def scaled(self, bandwidth_factor: float = 1.0,
               latency_factor: float = 1.0) -> "Interconnect":
        """A what-if copy with scaled bandwidth and/or latency (used by
        the sweep engine's interconnect axis and the monotonicity
        property tests)."""
        return dataclasses.replace(
            self,
            name=f"{self.name}x{bandwidth_factor:g}",
            bandwidth=self.bandwidth * bandwidth_factor,
            latency=self.latency * latency_factor,
        )


# ----------------------------------------------------------------------
# Collective algorithm primitives (alpha-beta closed forms).
#
# Each returns seconds for all-reducing ``nbytes`` bytes per rank over
# ``n`` ranks on a link with ``bandwidth`` effective bytes/s and
# ``latency`` seconds/message.  Every argument may be a NumPy array and
# broadcasts elementwise — the scenario-axis batched fast path
# (:mod:`repro_torch.core.batched`) passes per-scenario ``(n, bandwidth,
# latency)`` column vectors against per-layer ``nbytes`` row vectors to
# get ``(scenario x layer)`` cost matrices in one shot.
# ----------------------------------------------------------------------
def slowest_link(bandwidth, latency, axis: int = -1):
    """Reduce per-worker link vectors to the link that gates the
    collective: a synchronous all-reduce completes when its slowest
    participant finishes, so heterogeneous links collapse to
    ``(min bandwidth, max latency)`` over the worker axis.

    Degenerates bit-exactly to the scalar model when the vectors are
    constant (min/max never round), which is how the heterogeneous
    engine keeps homogeneous scenarios bit-identical.  Dtype-polymorphic
    over NumPy and torch like the collective models below.
    """
    xp = array_namespace(bandwidth, latency)
    return xp.min(bandwidth, axis=axis), xp.max(latency, axis=axis)


def ring_allreduce_time(nbytes, n, bandwidth, latency, worker_axis=None):
    """Ring all-reduce: ``2 (n-1)/n * M/B + 2 (n-1) alpha`` seconds.

    ``worker_axis`` marks ``bandwidth``/``latency`` as carrying a
    per-worker axis: the time is then gated by the slowest link
    (:func:`slowest_link` reduces that axis first).

    Bandwidth-optimal (each rank sends ``2 (n-1)/n`` of the payload)
    but latency grows linearly in ``n`` — the regime behind the 9.6%
    InfiniBand utilization the paper measured for layer-wise messages.

    Dtype-polymorphic: tensors (as in :mod:`repro_torch.core.batched_torch`)
    take the array path on torch; the Python-scalar branch is reserved for
    genuine host scalars, where ``if n <= 1`` is a host branch.
    """
    if worker_axis is not None:
        bandwidth, latency = slowest_link(bandwidth, latency, worker_axis)
    if not is_tensor(n) and np.ndim(n) == 0:
        if n <= 1:
            return nbytes * 0.0
        return 2.0 * (n - 1) / n * nbytes / bandwidth + 2.0 * (n - 1) * latency
    # Array path: zeroing the n <= 1 entries by mask *multiplication*
    # (0.0 * finite == 0.0 exactly) — np.where materializes both
    # branches and costs ~10x an elementwise multiply at sweep sizes.
    xp = array_namespace(nbytes, n, bandwidth, latency)
    n = xp.asarray(n, dtype=xp.float64)
    safe_n = xp.where(n > 1, n, 2.0)         # small: broadcast shape of n
    t = 2.0 * (safe_n - 1) / safe_n * nbytes / bandwidth \
        + 2.0 * (safe_n - 1) * latency
    return t * (n > 1)


def _ceil_log2(n, xp=np):
    """Exact ``ceil(log2 n)`` for integer arrays ``n >= 1`` (frexp-based
    so powers of two never round up a notch)."""
    m, e = xp.frexp(xp.asarray(n, dtype=xp.float64))
    return astype(xp.where(m == 0.5, e - 1, e), xp.float64)


def tree_allreduce_time(nbytes, n, bandwidth, latency, worker_axis=None):
    """Double-binary-tree all-reduce: ``2 M/B + 2 ceil(log2 n) alpha``.

    NCCL >= 2.4's tree pair pipelines reduce+broadcast so the bandwidth
    term is a flat ``2 M/B`` (slightly worse than ring's
    ``2 (n-1)/n M/B``) while latency grows only logarithmically —
    strictly better than ring for small messages on large clusters.
    ``worker_axis`` marks per-worker link vectors (see
    :func:`slowest_link`).
    """
    if worker_axis is not None:
        bandwidth, latency = slowest_link(bandwidth, latency, worker_axis)
    if not is_tensor(n) and np.ndim(n) == 0:
        if n <= 1:
            return nbytes * 0.0
        depth = math.ceil(math.log2(n))
        return 2.0 * nbytes / bandwidth + 2.0 * depth * latency
    xp = array_namespace(nbytes, n, bandwidth, latency)
    n = xp.asarray(n)
    depth = _ceil_log2(xp.where(n > 1, n, 2), xp)    # small: shape of n
    t = 2.0 * nbytes / bandwidth + 2.0 * depth * latency
    return t * (n > 1)


def hierarchical_allreduce_time(nbytes, n, gpus_per_node,
                                intra_bandwidth, intra_latency,
                                inter_bandwidth, inter_latency,
                                worker_axis=None):
    """Two-level all-reduce: ``g``-wide intra-node reduce-scatter,
    inter-node ring all-reduce of the ``nbytes/g`` shard, intra-node
    all-gather.  Degenerates to a flat intra ring on one node and to a
    flat inter ring with one device per node.

    Array-valued like the flat primitives: ``n`` / ``gpus_per_node`` /
    link parameters broadcast against ``nbytes``, which is how the
    batched fast path costs every scenario of a grid at once — and
    dtype-polymorphic, so the jit/vmap kernels trace the same code.
    ``worker_axis`` marks all four link parameters as per-worker
    vectors, each reduced to its slowest entry (:func:`slowest_link`).
    """
    if worker_axis is not None:
        intra_bandwidth, intra_latency = slowest_link(
            intra_bandwidth, intra_latency, worker_axis)
        inter_bandwidth, inter_latency = slowest_link(
            inter_bandwidth, inter_latency, worker_axis)
    xp = array_namespace(nbytes, n, gpus_per_node,
                         intra_bandwidth, inter_bandwidth)
    scalar = xp is np and np.ndim(n) == 0 and np.ndim(gpus_per_node) == 0
    n = xp.asarray(n, dtype=xp.int64)
    gpn = xp.asarray(gpus_per_node, dtype=xp.int64)
    g = xp.minimum(n, gpn)
    safe_g = xp.maximum(g, 1)
    nodes = (n + safe_g - 1) // safe_g          # exact ceil(n / g)
    gf = astype(safe_g, xp.float64)
    intra = 2.0 * ((gf - 1) / gf * nbytes / intra_bandwidth
                   + (gf - 1) * intra_latency)
    # ring_allreduce_time already mask-zeroes its nodes <= 1 entries
    t = intra * (g > 1) + ring_allreduce_time(
        nbytes / gf, astype(nodes, xp.float64),
        inter_bandwidth, inter_latency)
    if scalar and np.ndim(t) == 0:
        return float(t)
    return t


# ----------------------------------------------------------------------
# Affine collective coefficients.
#
# Every collective model above is *affine in the payload* for fixed
# ``(n, links)``: ``time(M) = per_byte * M + per_message`` whenever
# ``M > 0`` (callers mask zero payloads, exactly as the batched comm
# matrices do).  Factoring the coefficients out lets the batched
# kernels cost a whole layer/bucket table against one kernel point with
# a single multiply-add — prefix/suffix sums of ``time`` collapse to
# ``per_byte * (payload sums) + per_message * (payload counts)``, which
# is the cumsum-free formulation :mod:`repro_torch.core.batched` evaluates.
# Each function folds the ``n <= 1`` zeroing in (both coefficients are
# exactly 0.0 there) and is dtype-polymorphic like the time models.
# ----------------------------------------------------------------------
def ring_allreduce_coeffs(n, bandwidth, latency):
    """``(per_byte, per_message)`` of :func:`ring_allreduce_time`:
    ``2 (n-1)/n / B`` and ``2 (n-1) alpha``, zeroed where ``n <= 1``."""
    xp = array_namespace(n, bandwidth, latency)
    n = xp.asarray(n, dtype=xp.float64)
    live = n > 1
    safe_n = xp.where(live, n, 2.0)
    per_byte = 2.0 * (safe_n - 1) / safe_n / bandwidth * live
    per_message = 2.0 * (safe_n - 1) * latency * live
    return per_byte, per_message


def tree_allreduce_coeffs(n, bandwidth, latency):
    """``(per_byte, per_message)`` of :func:`tree_allreduce_time`:
    ``2 / B`` and ``2 ceil(log2 n) alpha``, zeroed where ``n <= 1``."""
    xp = array_namespace(n, bandwidth, latency)
    n = xp.asarray(n)
    live = n > 1
    depth = _ceil_log2(xp.where(live, n, 2), xp)
    per_byte = 2.0 / bandwidth * live
    per_message = 2.0 * depth * latency * live
    return per_byte, per_message


def hierarchical_allreduce_coeffs(n, gpus_per_node,
                                  intra_bandwidth, intra_latency,
                                  inter_bandwidth, inter_latency):
    """``(per_byte, per_message)`` of
    :func:`hierarchical_allreduce_time`: the intra-node term (live when
    ``g > 1``) plus the inter-node ring over the ``1/g`` shard (live
    when ``nodes > 1``), each contributing its own affine piece."""
    xp = array_namespace(n, gpus_per_node, intra_bandwidth,
                         inter_bandwidth)
    n = xp.asarray(n, dtype=xp.int64)
    gpn = xp.asarray(gpus_per_node, dtype=xp.int64)
    g = xp.minimum(n, gpn)
    safe_g = xp.maximum(g, 1)
    nodes = (n + safe_g - 1) // safe_g          # exact ceil(n / g)
    gf = astype(safe_g, xp.float64)
    intra_live = g > 1
    per_byte = 2.0 * (gf - 1) / gf / intra_bandwidth * intra_live
    per_message = 2.0 * (gf - 1) * intra_latency * intra_live
    ring_byte, ring_message = ring_allreduce_coeffs(
        astype(nodes, xp.float64), inter_bandwidth, inter_latency)
    return per_byte + ring_byte / gf, per_message + ring_message


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    peak_flops: float         # flop/s (the paper quotes peak incl. TensorCores)
    hbm_bandwidth: float      # bytes / s
    memory_bytes: float
    compute_efficiency: float = 0.5   # achieved fraction of peak in DNN layers


@dataclass(frozen=True)
class ClusterSpec:
    """A training cluster: N nodes x n_g devices, intra + inter connects.

    Mirrors Table II of the paper. ``allreduce_time`` implements the
    ring all-reduce alpha-beta model used to populate the DAG's
    communication nodes when no measured trace is available.
    """

    name: str
    device: DeviceSpec
    n_nodes: int
    gpus_per_node: int
    intra: Interconnect       # PCIe / NVLink / ICI
    inter: Interconnect      # 10GbE / InfiniBand / DCN
    disk: Interconnect        # storage read channel (t_io)
    h2d: Interconnect         # host-to-device copy channel (t_h2d)

    @property
    def total_devices(self) -> int:
        return self.n_nodes * self.gpus_per_node

    def with_workers(self, n_nodes: int, gpus_per_node: int | None = None) -> "ClusterSpec":
        g = self.gpus_per_node if gpus_per_node is None else gpus_per_node
        return dataclasses.replace(self, n_nodes=n_nodes, gpus_per_node=g)

    # ------------------------------------------------------------------
    # Collective models
    # ------------------------------------------------------------------
    def _bottleneck(self, n_workers: int) -> Interconnect:
        """The link a flat ring spanning ``n_workers`` devices is limited by."""
        if n_workers <= self.gpus_per_node:
            return self.intra
        return self.inter

    def with_interconnect(self, intra: Interconnect | None = None,
                          inter: Interconnect | None = None) -> "ClusterSpec":
        """A copy with the intra- and/or inter-node link replaced —
        the sweep engine's interconnect axis (PCIe vs NVLink vs 10GbE
        vs InfiniBand, the paper's four communication techniques)."""
        return dataclasses.replace(
            self,
            intra=intra if intra is not None else self.intra,
            inter=inter if inter is not None else self.inter,
        )

    def allreduce_time(self, nbytes, n_workers: int | None = None,
                       algorithm: str = "ring"):
        """All-reduce of ``nbytes`` bytes per rank over ``n_workers``
        devices; returns **seconds**.

        ``algorithm`` selects the cost model (see
        :data:`COLLECTIVE_ALGORITHMS`):

        * ``ring`` — Eq.-style ``2 (n-1)/n M/B + 2 (n-1) alpha`` on the
          bottleneck link (the paper's NCCL baseline, and this method's
          historical behavior).
        * ``tree`` — double binary tree, ``2 M/B + 2 ceil(log2 n) alpha``
          on the bottleneck link.
        * ``hierarchical`` — intra-node reduce-scatter + all-gather on
          the intra link around an inter-node ring all-reduce of the
          ``1/g`` shard on the inter link (NCCL "CollNet"/2D style).

        ``nbytes`` may be a scalar or a NumPy array (vectorized over
        the layer dimension by the sweep fast path).
        """
        if algorithm not in COLLECTIVE_ALGORITHMS:
            raise ValueError(
                f"unknown collective algorithm {algorithm!r}; "
                f"one of {COLLECTIVE_ALGORITHMS}")
        n = self.total_devices if n_workers is None else n_workers
        if n <= 1:
            return nbytes * 0.0
        if algorithm == "hierarchical":
            return self._hierarchical_allreduce_time(nbytes, n)
        link = self._bottleneck(n)
        if algorithm == "ring":
            return ring_allreduce_time(nbytes, n, link.effective_bandwidth,
                                       link.latency)
        return tree_allreduce_time(nbytes, n, link.effective_bandwidth,
                                   link.latency)

    def _hierarchical_allreduce_time(self, nbytes, n: int):
        """Delegates to :func:`hierarchical_allreduce_time` — one
        implementation shared with the batched fast path so the scalar
        and scenario-axis vectorized costs cannot drift."""
        return hierarchical_allreduce_time(
            nbytes, n, self.gpus_per_node,
            self.intra.effective_bandwidth, self.intra.latency,
            self.inter.effective_bandwidth, self.inter.latency)

    def reduce_scatter_time(self, nbytes: float, n_workers: int | None = None) -> float:
        """Ring reduce-scatter of ``nbytes`` bytes per rank, in seconds:
        ``(n-1)/n * M/B + (n-1) alpha`` on the bottleneck link."""
        n = self.total_devices if n_workers is None else n_workers
        if n <= 1:
            return 0.0
        link = self._bottleneck(n)
        return (n - 1) / n * nbytes / link.effective_bandwidth \
            + (n - 1) * link.latency

    def allgather_time(self, nbytes: float, n_workers: int | None = None) -> float:
        """Ring all-gather — same alpha-beta cost as reduce-scatter."""
        return self.reduce_scatter_time(nbytes, n_workers)

    def alltoall_time(self, nbytes: float, n_workers: int | None = None) -> float:
        """All-to-all of ``nbytes`` bytes held per device (MoE dispatch),
        in seconds."""
        n = self.total_devices if n_workers is None else n_workers
        if n <= 1:
            return 0.0
        link = self._bottleneck(n)
        return (n - 1) / n * nbytes / link.effective_bandwidth \
            + (n - 1) * link.latency

    # ------------------------------------------------------------------
    # Elementary task models (the paper's Table I vocabulary)
    # ------------------------------------------------------------------
    def compute_time(self, flops: float) -> float:
        """Seconds to execute ``flops`` floating-point operations at the
        device's achieved rate (``peak_flops * compute_efficiency``) —
        feeds the DAG's ``t_f`` / ``t_b`` nodes."""
        return flops / (self.device.peak_flops * self.device.compute_efficiency)

    def io_time(self, nbytes: float) -> float:
        """Seconds to read ``nbytes`` bytes from storage (``t_io``)."""
        return self.disk.transfer_time(nbytes)

    def h2d_time(self, nbytes: float) -> float:
        """Seconds to copy ``nbytes`` bytes host->device (``t_h2d``)."""
        return self.h2d.transfer_time(nbytes)


# ----------------------------------------------------------------------
# Paper Table II clusters.
#
# Collective efficiencies are calibrated against the paper's measured
# numbers (Section V-C2): training ResNet-50 on the V100 cluster the
# per-iteration gradient communication is ~79.7 ms for ~24M f32
# parameters over 16 GPUs — the paper reports NCCL2 achieving only
# ~9.6% of the 100Gb/s InfiniBand bandwidth due to layer-wise small
# messages.  The K80 cluster's 10GbE reaches a much larger fraction of
# its (far lower) peak.
# ----------------------------------------------------------------------
# Compute efficiencies calibrated against the paper's measured ResNet-50
# per-iteration times (§V-C2): K80 backward 0.243 s, V100 backward
# 0.0625 s at batch 32 (ResNet-50 fwd ~7.7 GFLOP/sample, bwd ~2x fwd).
K80_DEVICE = DeviceSpec(
    name="Tesla K80",
    peak_flops=4.37e12,
    hbm_bandwidth=240 * GB,
    memory_bytes=12 * GB,
    compute_efficiency=0.47,
)

V100_DEVICE = DeviceSpec(
    name="Tesla V100",
    peak_flops=125e12,        # with Tensor Cores, as quoted in the paper
    hbm_bandwidth=900 * GB,
    memory_bytes=16 * GB,
    # Calibrated: 0.0625 s for ResNet-50 backward at batch 32 implies
    # ~7.9 TFLOP/s achieved — 6.3% of the quoted 125 TFLOP TensorCore
    # peak (fp32 training largely bypasses TensorCores; the paper's own
    # point is that quoted peak vastly outruns end-to-end compute).
    compute_efficiency=0.063,
)

K80_CLUSTER = ClusterSpec(
    name="k80-pcie-10gbe",
    device=K80_DEVICE,
    n_nodes=4,
    gpus_per_node=4,
    intra=Interconnect("pcie3", 15 * GB, 10 * US, efficiency=0.7),
    inter=Interconnect("10gbe", 1.25 * GB, 50 * US, efficiency=0.7),
    disk=Interconnect("nfs", 1.1 * GB, 1e-4),
    h2d=Interconnect("pcie3-h2d", 15 * GB, 10 * US, efficiency=0.8),
)

V100_CLUSTER = ClusterSpec(
    name="v100-nvlink-ib",
    device=V100_DEVICE,
    n_nodes=4,
    gpus_per_node=4,
    intra=Interconnect("nvlink", 95 * GB, 5 * US, efficiency=0.6),
    # 100Gbps IB = 12.5 GB/s peak.  Efficiency calibrated so the ring
    # all-reduce of ResNet-50's 102 MB of f32 gradients over 16 GPUs
    # costs the measured 79.7 ms (the paper reports NCCL2 reaching only
    # ~9.6% of raw link bandwidth when counting the layer-wise message
    # pattern; 0.19 is the matching end-to-end collective efficiency).
    inter=Interconnect("ib-100g", 12.5 * GB, 10 * US, efficiency=0.19),
    disk=Interconnect("ssd", 367.3 * MB, 1e-4),
    h2d=Interconnect("pcie3-h2d", 15 * GB, 10 * US, efficiency=0.8),
)

# ----------------------------------------------------------------------
# Production target: TPU v5e pod(s).  One pod = 16x16 chips on a 2D ICI
# torus; pods connect over DCN.  Constants per the assignment:
#   197 TFLOP/s bf16 / chip, 819 GB/s HBM, ~50 GB/s/link ICI.
# DCN per-chip bandwidth is an assumption (documented in DESIGN.md).
# ----------------------------------------------------------------------
TPU_V5E = DeviceSpec(
    name="TPU v5e",
    peak_flops=197e12,
    hbm_bandwidth=819 * GB,
    memory_bytes=16 * GB,
    compute_efficiency=0.55,
)

TPU_V5E_POD = ClusterSpec(
    name="tpu-v5e-pod",
    device=TPU_V5E,
    n_nodes=1,
    gpus_per_node=256,
    intra=Interconnect("ici", 50 * GB, 1 * US, efficiency=0.8),
    inter=Interconnect("dcn", 6.25 * GB, 10 * US, efficiency=0.8),
    disk=Interconnect("gcs", 2 * GB, 1e-3),
    h2d=Interconnect("pcie-host", 32 * GB, 10 * US),
)

TPU_V5E_MULTIPOD = dataclasses.replace(TPU_V5E_POD, name="tpu-v5e-2pod", n_nodes=2)

CLUSTERS = {c.name: c for c in (K80_CLUSTER, V100_CLUSTER, TPU_V5E_POD, TPU_V5E_MULTIPOD)}

# ----------------------------------------------------------------------
# Interconnect presets — the sweep engine's interconnect axis.
#
# Each preset names a link and the slot it replaces on a ClusterSpec
# ("intra" or "inter"); the paper's four communication techniques
# (PCIe, NVLink, 10GbE, InfiniBand) plus faster what-if variants.
# ----------------------------------------------------------------------
INTERCONNECT_PRESETS: dict[str, tuple[str, Interconnect]] = {
    "pcie": ("intra", Interconnect("pcie3", 15 * GB, 10 * US, efficiency=0.7)),
    "nvlink": ("intra", Interconnect("nvlink", 95 * GB, 5 * US, efficiency=0.6)),
    "10gbe": ("inter", Interconnect("10gbe", 1.25 * GB, 50 * US, efficiency=0.7)),
    "ib-100g": ("inter", Interconnect("ib-100g", 12.5 * GB, 10 * US, efficiency=0.19)),
    # What-if links beyond the paper's testbeds: IB with DDP-style bucket
    # fusion reaches far higher collective efficiency, and 200G doubles
    # the rate.  Useful sweep points for the §VII optimization study.
    "ib-100g-fused": ("inter", Interconnect("ib-100g-fused", 12.5 * GB, 10 * US,
                                            efficiency=0.7)),
    "ib-200g": ("inter", Interconnect("ib-200g", 25 * GB, 10 * US, efficiency=0.7)),
}


def resolve_interconnect_preset(preset: str) -> tuple[str, Interconnect]:
    """``(slot, link)`` for a preset name, including the *scaled-preset
    grammar* ``<base>@bw<F>@lat<F>``: a base preset with its bandwidth
    and/or latency multiplied by ``F`` (either modifier may be omitted,
    order-free).  ``"ib-100g@bw2@lat0.25"`` is 2x the bandwidth at a
    quarter of the latency of ``ib-100g`` — the frontier grid sweeps
    these what-ifs without registering hundreds of named presets.

    Raises ``KeyError`` for unknown bases and ``ValueError`` for
    malformed modifiers.
    """
    base, _, mods = preset.partition("@")
    try:
        slot, link = INTERCONNECT_PRESETS[base]
    except KeyError:
        raise KeyError(f"unknown interconnect preset {base!r}; "
                       f"one of {sorted(INTERCONNECT_PRESETS)} or 'default'")
    if not mods:
        return slot, link
    bw_factor = lat_factor = 1.0
    for mod in mods.split("@"):
        if mod.startswith("bw"):
            bw_factor = float(mod[2:])
        elif mod.startswith("lat"):
            lat_factor = float(mod[3:])
        else:
            raise ValueError(
                f"malformed interconnect modifier {mod!r} in {preset!r}; "
                f"expected bw<factor> or lat<factor>")
        if bw_factor <= 0 or lat_factor < 0:
            raise ValueError(f"interconnect factors must be positive "
                             f"(latency may be 0), got {preset!r}")
    return slot, dataclasses.replace(
        link, name=preset, bandwidth=link.bandwidth * bw_factor,
        latency=link.latency * lat_factor)


def apply_interconnect_preset(cluster: ClusterSpec, preset: str | None) -> ClusterSpec:
    """Return ``cluster`` with the named preset's link substituted in.

    ``None`` (or ``"default"``) leaves the cluster untouched; scaled
    presets (``<base>@bw<F>@lat<F>``) resolve through
    :func:`resolve_interconnect_preset`.
    """
    if preset is None or preset == "default":
        return cluster
    slot, link = resolve_interconnect_preset(preset)
    return cluster.with_interconnect(**{slot: link})
