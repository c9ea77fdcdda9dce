"""Per-layer cost model of the paper's own CNN workloads (Table IV:
AlexNet, GoogleNet, ResNet-50): a copy of :mod:`repro.core.costmodel`
(the layer tables, :data:`CNN_WORKLOADS`, :func:`total_params`,
:func:`total_flops`, :func:`make_iteration_costs`, :func:`update_time` and
:func:`comm_scale_fn`).

Layer tables are generated from the published architectures and populate
the DAG's communication and computation nodes when no measured trace is
available.  FLOPs are *per training sample* multiply-accumulate*2 for the
forward pass; backward is modeled as ``2x`` forward (dgrad + wgrad).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from repro_torch.core.dag import IterationCosts
from repro_torch.core.hardware import ClusterSpec


@dataclass(frozen=True)
class LayerSpec:
    """One DAG layer's static costs: ``flops_fwd`` in **flop/sample**
    (forward pass), ``params`` as a raw count (0 = no gradient sync
    node for this layer in Fig. 1)."""

    name: str
    flops_fwd: float          # per-sample forward flops
    params: int               # learnable parameter count (0 = no gradient sync)

    @property
    def grad_bytes(self) -> float:
        """Gradient all-reduce payload in **bytes** (f32, as in the paper)."""
        return 4.0 * self.params


def conv(name: str, h: int, w: int, cout: int, k: int, cin: int,
         groups: int = 1) -> LayerSpec:
    """Conv layer: ``h x w`` output, ``k x k`` kernel — flops are
    multiply-accumulate*2 per sample, params include the bias."""
    cin_g = cin // groups
    flops = 2.0 * h * w * cout * k * k * cin_g
    params = cout * (k * k * cin_g) + cout
    return LayerSpec(name, flops, params)


def fc(name: str, nin: int, nout: int) -> LayerSpec:
    """Fully-connected layer: ``2 * nin * nout`` flop/sample."""
    return LayerSpec(name, 2.0 * nin * nout, nin * nout + nout)


def act(name: str, elems: int) -> LayerSpec:
    """Activation / pooling / norm: ~1 flop per element, no params —
    never produces a communication node."""
    return LayerSpec(name, float(elems), 0)


# ----------------------------------------------------------------------
# AlexNet (Krizhevsky 2012, LRN excluded per the paper's Table IV note).
# ----------------------------------------------------------------------
def alexnet_layers() -> list[LayerSpec]:
    return [
        conv("conv1", 55, 55, 96, 11, 3),
        act("relu1+pool1", 55 * 55 * 96 + 27 * 27 * 96),
        conv("conv2", 27, 27, 256, 5, 96, groups=2),
        act("relu2+pool2", 27 * 27 * 256 + 13 * 13 * 256),
        conv("conv3", 13, 13, 384, 3, 256),
        act("relu3", 13 * 13 * 384),
        conv("conv4", 13, 13, 384, 3, 384, groups=2),
        act("relu4", 13 * 13 * 384),
        conv("conv5", 13, 13, 256, 3, 384, groups=2),
        act("relu5+pool5", 13 * 13 * 256 + 6 * 6 * 256),
        fc("fc6", 9216, 4096),
        act("relu6+drop6", 4096 * 2),
        fc("fc7", 4096, 4096),
        act("relu7+drop7", 4096 * 2),
        fc("fc8", 4096, 1000),
    ]


# ----------------------------------------------------------------------
# ResNet-50 (He et al. 2015).
# ----------------------------------------------------------------------
def resnet50_layers() -> list[LayerSpec]:
    layers: list[LayerSpec] = [conv("conv1", 112, 112, 64, 7, 3)]
    cfg = [  # (blocks, in_ch, mid_ch, out_ch, spatial)
        (3, 64, 64, 256, 56),
        (4, 256, 128, 512, 28),
        (6, 512, 256, 1024, 14),
        (3, 1024, 512, 2048, 7),
    ]
    for stage, (blocks, cin, mid, cout, hw) in enumerate(cfg, start=2):
        for b in range(blocks):
            cin_b = cin if b == 0 else cout
            pre = f"res{stage}{chr(ord('a') + b)}"
            layers.append(conv(f"{pre}_1x1a", hw, hw, mid, 1, cin_b))
            layers.append(conv(f"{pre}_3x3", hw, hw, mid, 3, mid))
            layers.append(conv(f"{pre}_1x1b", hw, hw, cout, 1, mid))
            if b == 0:
                layers.append(conv(f"{pre}_proj", hw, hw, cout, 1, cin_b))
            layers.append(act(f"{pre}_bn_relu", 3 * hw * hw * cout))
    layers.append(fc("fc1000", 2048, 1000))
    return layers


# ----------------------------------------------------------------------
# GoogleNet / Inception-v1 (Szegedy et al. 2015).
# Note: actual parameter count is ~7M; the paper's Table IV quotes
# "~53 millions", which does not match the published architecture — we
# use the real architecture (documented deviation, DESIGN.md §9).
# ----------------------------------------------------------------------
_INCEPTION = [  # name, hw, cin, 1x1, 3x3red, 3x3, 5x5red, 5x5, pool_proj
    ("3a", 28, 192, 64, 96, 128, 16, 32, 32),
    ("3b", 28, 256, 128, 128, 192, 32, 96, 64),
    ("4a", 14, 480, 192, 96, 208, 16, 48, 64),
    ("4b", 14, 512, 160, 112, 224, 24, 64, 64),
    ("4c", 14, 512, 128, 128, 256, 24, 64, 64),
    ("4d", 14, 512, 112, 144, 288, 32, 64, 64),
    ("4e", 14, 528, 256, 160, 320, 32, 128, 128),
    ("5a", 7, 832, 256, 160, 320, 32, 128, 128),
    ("5b", 7, 832, 384, 192, 384, 48, 128, 128),
]


def googlenet_layers() -> list[LayerSpec]:
    layers = [
        conv("conv1", 112, 112, 64, 7, 3),
        conv("conv2_red", 56, 56, 64, 1, 64),
        conv("conv2", 56, 56, 192, 3, 64),
    ]
    for name, hw, cin, c1, c3r, c3, c5r, c5, cp in _INCEPTION:
        flops = params = 0.0
        for spec in (conv("x", hw, hw, c1, 1, cin),
                     conv("x", hw, hw, c3r, 1, cin),
                     conv("x", hw, hw, c3, 3, c3r),
                     conv("x", hw, hw, c5r, 1, cin),
                     conv("x", hw, hw, c5, 5, c5r),
                     conv("x", hw, hw, cp, 1, cin)):
            flops += spec.flops_fwd
            params += spec.params
        layers.append(LayerSpec(f"inception_{name}", flops, int(params)))
    layers.append(fc("fc1000", 1024, 1000))
    return layers


CNN_WORKLOADS = {
    # name -> (layer list builder, per-GPU batch from Table IV, bytes/sample on disk)
    "alexnet": (alexnet_layers, 1024, 110e3),
    "googlenet": (googlenet_layers, 64, 110e3),
    "resnet50": (resnet50_layers, 32, 110e3),
}


def total_params(layers: Sequence[LayerSpec]) -> int:
    """Total learnable parameter count (multiply by 4 for f32 bytes)."""
    return sum(l.params for l in layers)


def total_flops(layers: Sequence[LayerSpec]) -> float:
    """Total forward flop/sample across the layer table."""
    return sum(l.flops_fwd for l in layers)


# ----------------------------------------------------------------------
# LayerSpec list -> IterationCosts on a concrete cluster.
# ----------------------------------------------------------------------
def make_iteration_costs(
    layers: Sequence[LayerSpec] | str,
    cluster: ClusterSpec,
    batch_per_gpu: int,
    n_workers: int,
    bytes_per_sample: float | None = None,
    bwd_fwd_ratio: float | None = None,
    decode_seconds_per_byte: float = 0.0,
    collective: str = "ring",
) -> IterationCosts:
    """Build the paper's Table-I cost vocabulary (all entries in
    **seconds**) from a layer table.

    ``layers`` may also be a workload *name* (``"resnet50"``,
    ``"cnn:alexnet"``, ``"trace:alexnet-k80"``, ``"llm:gemma3-1b"`` —
    anything :func:`repro_torch.core.workloads.resolve_workload` accepts), in
    which case the memoized registry table supplies the per-layer
    costs; ``bytes_per_sample`` ``None`` then means the workload's own
    value (and 110e3, the Table-IV ImageNet figure, for a layer table).

    From a layer table:

    * ``t_f``/``t_b`` per layer from per-sample forward FLOPs at the
      device's achieved flop/s (backward = ``bwd_fwd_ratio`` x forward);
    * ``t_c`` per layer from the cluster's all-reduce model for
      ``collective`` (one of
      :data:`repro_torch.core.hardware.COLLECTIVE_ALGORITHMS`);
    * ``t_io``/``t_h2d`` from ``batch_per_gpu * bytes_per_sample`` bytes
      over the disk and PCIe links (Eq. 1's input pipeline terms);
    * ``t_u`` as one read-modify-write sweep over all parameter bytes at
      HBM bandwidth.

    ``decode_seconds_per_byte`` models host-side JPEG decode in
    **seconds per input byte** — achieved host decode rate, inverted
    (the paper attributes CNTK/TF's poor AlexNet scaling to CPU-side
    decoding of 4096 images/iter); it inflates ``t_io``.
    """
    if isinstance(layers, str):
        from repro_torch.core.workloads import resolve_workload  # circular-safe

        return resolve_workload(layers).iteration_costs(
            cluster, batch_per_gpu, n_workers, collective,
            bwd_fwd_ratio=bwd_fwd_ratio,
            bytes_per_sample=bytes_per_sample,
            decode_seconds_per_byte=decode_seconds_per_byte)
    if bytes_per_sample is None:
        bytes_per_sample = 110e3
    if bwd_fwd_ratio is None:
        bwd_fwd_ratio = 2.0
    t_f = [cluster.compute_time(l.flops_fwd * batch_per_gpu) for l in layers]
    t_b = [bwd_fwd_ratio * tf for tf in t_f]
    t_c = [cluster.allreduce_time(l.grad_bytes, n_workers, collective)
           if l.params else 0.0 for l in layers]
    grad_bytes = [l.grad_bytes for l in layers]
    nbytes_in = batch_per_gpu * bytes_per_sample
    t_io = cluster.io_time(nbytes_in) + decode_seconds_per_byte * nbytes_in
    t_h2d = cluster.h2d_time(nbytes_in)
    t_u = update_time(4.0 * total_params(layers), cluster)
    return IterationCosts(t_f=t_f, t_b=t_b, t_c=t_c, t_io=t_io, t_h2d=t_h2d,
                          t_u=t_u, grad_bytes=grad_bytes)


def update_time(param_bytes: float, cluster: ClusterSpec) -> float:
    """``t_u`` in seconds: the SGD update as one read-modify-write
    sweep over ``param_bytes`` bytes of parameters at HBM bandwidth
    (3x traffic: read param, read grad, write param)."""
    return 3.0 * param_bytes / cluster.device.hbm_bandwidth


def comm_scale_fn(cluster: ClusterSpec, n_workers: int,
                  collective: str = "ring"):
    """Bucket-fusion collective model for the DAG builder: maps a fused
    bucket's total gradient bytes to one collective's duration in
    seconds under the chosen algorithm (ring / tree / hierarchical)."""

    def scale(total_bytes: float, _naive_time: float) -> float:
        return cluster.allreduce_time(total_bytes, n_workers, collective)

    return scale
