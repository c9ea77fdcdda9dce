"""The paper's CNN workloads (Table IV) as real torch models.

Counterpart of :mod:`repro.models.cnn`.  AlexNet and ResNet are built as
*lists of named layers* so the trace generator
(:mod:`repro_torch.traces.generate`) can time each layer's forward and
backward separately: the layer-wise method behind the paper's Table VI
traces, on the card.

Layout: activations are logical NCHW tensors in ``torch.channels_last``
memory (the reference's NHWC), convolution weights OIHW (also
channels_last), fully connected weights (in, out) as in the reference.
Padding is XLA's: ``SAME`` pads ``total // 2`` before and the rest after,
so a strided convolution can pad one pixel more at the end than at the
start.  The convolutions, pools and products are cuDNN / cuBLAS calls, as
the reference's are ``lax`` calls outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.common import dense_init
from repro_torch.traces.generate import TimedLayer

CL = torch.channels_last


def _generator(seed: int | torch.Generator) -> torch.Generator:
    """Weights are drawn on the CPU, so a seed gives the same model on
    every device."""
    return seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA ``SAME`` padding (before, after) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
          padding: str) -> torch.Tensor:
    if padding == "SAME":
        (ht, hb), (wl, wr) = (_same_pads(x.shape[2], w.shape[2], stride),
                              _same_pads(x.shape[3], w.shape[3], stride))
        if (ht, wl) == (hb, wr):
            # symmetric pads go to cuDNN itself: no padded copy of x
            return F.conv2d(x, w, b, stride, (ht, wl))
        x = F.pad(x, (wl, wr, ht, hb))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return F.conv2d(x, w, b, stride)


def _conv_apply(stride: int, padding: str = "SAME"):
    def apply(p, x):
        return F.relu(_conv(x, p["w"], p["b"], stride, padding))
    return apply


def _conv_init(gen, kh, cin, cout, device, dtype=torch.float32):
    w = dense_init(gen, (cout, cin, kh, kh), dtype, "cpu", in_axis_size=kh * kh * cin)
    return {"w": w.to(device).contiguous(memory_format=CL),
            "b": torch.zeros((cout,), dtype=dtype, device=device)}


def _maxpool(window: int, stride: int):
    def apply(_p, x):
        return F.max_pool2d(x, window, stride)
    return apply


def _fc_apply(relu: bool = True):
    def apply(p, x):
        if x.dim() == 4:
            # flatten in the reference's (h, w, c) order, so fc6's rows
            # carry over unchanged
            x = x.permute(0, 2, 3, 1)
        y = x.reshape(x.shape[0], -1) @ p["w"] + p["b"]
        return F.relu(y) if relu else y
    return apply


def _fc_init(gen, nin, nout, device, dtype=torch.float32):
    return {"w": dense_init(gen, (nin, nout), dtype, "cpu").to(device),
            "b": torch.zeros((nout,), dtype=dtype, device=device)}


def _input(hw: int, device) -> torch.Tensor:
    return torch.zeros((1, 3, hw, hw), dtype=torch.float32, device=device) \
        .contiguous(memory_format=CL)


#: ImageNet's classes: the width of AlexNet's fc8 and ResNet's fc.
NUM_CLASSES = 1000


# ----------------------------------------------------------------------
# AlexNet (LRN excluded, per the paper)
# ----------------------------------------------------------------------
def _pooled(size: int) -> int:
    return (size - 3) // 2 + 1


def alexnet_timed_layers(seed: int | torch.Generator = 0, input_hw: int = 224,
                         device=None) -> tuple[list[TimedLayer], torch.Tensor]:
    """AlexNet's 11 timed layers and a zero input of batch 1, on ``device``
    (default CUDA).  fc6's width follows pool5's output: 5 x 5 x 256 at
    224."""
    dev = resolve_device(device)
    gen = _generator(seed)
    layers = [
        TimedLayer("conv1", _conv_apply(4, "VALID"), _conv_init(gen, 11, 3, 96, dev)),
        TimedLayer("pool1", _maxpool(3, 2), {}),
        TimedLayer("conv2", _conv_apply(1), _conv_init(gen, 5, 96, 256, dev)),
        TimedLayer("pool2", _maxpool(3, 2), {}),
        TimedLayer("conv3", _conv_apply(1), _conv_init(gen, 3, 256, 384, dev)),
        TimedLayer("conv4", _conv_apply(1), _conv_init(gen, 3, 384, 384, dev)),
        TimedLayer("conv5", _conv_apply(1), _conv_init(gen, 3, 384, 256, dev)),
        TimedLayer("pool5", _maxpool(3, 2), {}),
    ]
    side = _pooled(_pooled(_pooled((input_hw - 11) // 4 + 1)))
    if side < 1:
        raise ValueError(f"input {input_hw}x{input_hw} leaves pool5 empty; AlexNet needs >= 67")
    flat = 256 * side * side
    layers += [
        TimedLayer("fc6", _fc_apply(), _fc_init(gen, flat, 4096, dev)),
        TimedLayer("fc7", _fc_apply(), _fc_init(gen, 4096, 4096, dev)),
        TimedLayer("fc8", _fc_apply(relu=False), _fc_init(gen, 4096, NUM_CLASSES, dev)),
    ]
    return layers, _input(input_hw, dev)


# ----------------------------------------------------------------------
# ResNet (bottleneck): each residual block is one timed "layer", the
# granularity of the paper's ResNet-50 traces.  depth_per_stage=(3,4,6,3)
# is ResNet-50; smaller settings give CPU-sized variants.
# ----------------------------------------------------------------------
def _bottleneck_init(gen, cin, mid, cout, stride, device):
    p = {"c1": _conv_init(gen, 1, cin, mid, device),
         "c2": _conv_init(gen, 3, mid, mid, device),
         "c3": _conv_init(gen, 1, mid, cout, device)}
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(gen, 1, cin, cout, device)
    return p


def _bottleneck_apply(stride: int):
    def apply(p, x):
        y = _conv_apply(1)(p["c1"], x)
        y = _conv_apply(stride)(p["c2"], y)
        # no ReLU on c3 and proj: it comes after the sum
        y = _conv(y, p["c3"]["w"], p["c3"]["b"], 1, "SAME")
        if "proj" in p:
            x = _conv(x, p["proj"]["w"], p["proj"]["b"], stride, "SAME")
        return F.relu(x + y)
    return apply


def _pool_fc_apply(p, x):
    return x.mean(dim=(2, 3)) @ p["w"] + p["b"]


def resnet_timed_layers(seed: int | torch.Generator = 0, input_hw: int = 224,
                        depth_per_stage: Sequence[int] = (3, 4, 6, 3),
                        width: int = 64, device=None) -> tuple[list[TimedLayer], torch.Tensor]:
    """ResNet's timed layers (conv1, pool1, one per bottleneck block, fc:
    19 for ResNet-50) and a zero input of batch 1, on ``device`` (default
    CUDA)."""
    dev = resolve_device(device)
    gen = _generator(seed)
    layers = [TimedLayer("conv1", _conv_apply(2), _conv_init(gen, 7, 3, width, dev)),
              TimedLayer("pool1", _maxpool(3, 2), {})]
    cin = width
    for stage, blocks in enumerate(depth_per_stage):
        mid = width * (2 ** stage)
        cout = mid * 4
        for b in range(blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            layers.append(TimedLayer(
                f"res{stage + 2}{chr(ord('a') + b)}", _bottleneck_apply(stride),
                _bottleneck_init(gen, cin, mid, cout, stride, dev)))
            cin = cout
    layers.append(TimedLayer("fc", _pool_fc_apply, _fc_init(gen, cin, NUM_CLASSES, dev)))
    return layers, _input(input_hw, dev)


# ----------------------------------------------------------------------
# Parameter bridge from the reference
# ----------------------------------------------------------------------
def _bridge(tree, device):
    if isinstance(tree, dict):
        return {k: _bridge(v, device) for k, v in tree.items()}
    t = torch.from_numpy(tree.copy()).to(device)
    if t.dim() == 4:
        # HWIO -> OIHW
        return t.permute(3, 2, 0, 1).contiguous(memory_format=CL)
    return t


def from_reference(layer_params: Sequence, device="cpu") -> list:
    """The port's per-layer parameters from the reference's (each layer's
    ``TimedLayer.params`` as nested dicts of numpy arrays): convolution
    weights HWIO -> OIHW, everything else unchanged.  Put them into the
    port's layers with ``dataclasses.replace(layer, params=p)``."""
    return [_bridge(p, device) for p in layer_params]
