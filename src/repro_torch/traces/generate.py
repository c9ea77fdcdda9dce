"""Trace generator: instrument a real torch model into the paper's
layer-wise trace format.

Counterpart of :mod:`repro.traces.generate`.  The paper measured
Caffe-MPI's per-layer forward/backward/comm times; here each layer's
forward and its gradient are timed on the device the inputs live on, and
gradient sizes come from the parameter tree, giving a
:class:`~repro_torch.traces.format.Trace` that the DAG predictor
consumes: measure -> trace -> DAG -> predict, end to end.

As in the reference, the backward column times one call of the gradient
of ``apply(params, x).sum()``, which runs the layer's forward again: a
trace's backward includes its forward.
"""
from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch

from repro_torch.models.transformer import leaf_order, map_leaves
from repro_torch.traces.format import LayerRecord, Trace


@dataclass(frozen=True)
class TimedLayer:
    """A named layer: ``apply(params, x) -> y`` plus its parameters (a
    tensor, or nested dicts of tensors)."""

    name: str
    apply: Callable[[Any, Any], Any]
    params: Any


def _leaves(params: Any) -> list[torch.Tensor]:
    return [t for _, t in leaf_order(params)]


def _param_bytes(params: Any) -> float:
    return float(sum(t.numel() * t.element_size() for t in _leaves(params)))


def _block(device: torch.device) -> None:
    """The reference's ``block_until_ready``: wait for the device."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_call(fn, *args, repeats: int, device: torch.device) -> float:
    """Median wall time of ``fn(*args)`` in microseconds (post-warmup),
    each call closed by a device synchronize."""
    fn(*args)
    _block(device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        _block(device)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e6


@contextlib.contextmanager
def tf32(enabled: bool):
    """cuDNN convolutions and cuBLAS matmuls in TF32 or, with
    ``enabled=False``, in full float32 (as the reference computes float32
    layers); the flags are restored on exit."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


#: A float32 layer on the card against the CPU or float64: |err| <= this
#: much of each tensor's scale.  On an NVIDIA H100 the CNNs read at most
#: 3.0e-6 in float32 and at least 1.2e-1 (reduced, against the CPU) and
#: 4.5e-4 (full width, against float64) in TF32 (``chip_smoke.py`` prints
#: both), so a layer run in TF32 fails it.
F32_LIMIT = 2e-5


def layer_errors(cpu_layers: Sequence[TimedLayer], layers: Sequence[TimedLayer],
                 x: torch.Tensor, tf32_on: bool = False) -> tuple[float, str]:
    """``layers`` on their device against the same layers on the CPU, fed
    ``x`` (on the CPU): each layer's forward and the gradient of its sum in
    the parameters and the input (the backward column's call), every layer
    given the CPU's output of the layer before.  Returns the worst
    |difference| over max(1, max |CPU|) of a tensor, and where; TF32 is off
    unless ``tf32_on``."""
    device = next(t.device for layer in layers for t in _leaves(layer.params))
    worst, where = 0.0, ""
    with tf32(tf32_on):
        for lc, ld in zip(cpu_layers, layers):
            outs = []
            for layer, dev in ((lc, "cpu"), (ld, device)):
                params = map_leaves(lambda _, t: t.detach().requires_grad_(True), layer.params)
                xi = x.detach().to(dev).requires_grad_(True)
                y = layer.apply(params, xi)
                grads = torch.autograd.grad(y.sum(), _leaves(params) + [xi])
                outs.append([y.detach().cpu()] + [g.cpu() for g in grads])
            for k, (want, got) in enumerate(zip(*outs)):
                err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
                if not torch.isfinite(got).all():
                    err = math.inf
                if err >= worst:
                    worst, where = err, f"{lc.name} {'output' if k == 0 else f'grad {k}'}"
            x = outs[0][0]
            if x.dim() == 4:
                x = x.contiguous(memory_format=torch.channels_last)
    return worst, where


def generate_trace(
    layers: Sequence[TimedLayer],
    x0: Any,
    network: str,
    cluster: str = "cpu-host",
    n_iterations: int = 3,
    repeats: int = 5,
    comm_time_fn: Callable[[float], float] | None = None,
) -> Trace:
    """Measure per-layer fwd/bwd wall time and emit a paper-format trace.

    The layers run on ``x0``'s device, with TF32 off (:func:`tf32`).
    ``comm_time_fn(grad_bytes) -> seconds`` fills the Comm. column (e.g. a
    :meth:`ClusterSpec.allreduce_time` closure); default 0 (single device,
    as Eq. (1)).
    """
    device = x0.device
    # VJP per layer: d(sum(y))/d(params [, x]); integer inputs (token ids
    # into an embedding) only differentiate the parameters.
    grad_params = [map_leaves(lambda _, t: t.detach().requires_grad_(True), layer.params)
                   for layer in layers]

    def fwd(apply, params, x):
        with torch.no_grad():
            return apply(params, x)

    def bwd(apply, params, x):
        xs = [x] if x.requires_grad else []
        return torch.autograd.grad(apply(params, x).sum(), _leaves(params) + xs)

    iters: list[tuple[LayerRecord, ...]] = []
    with tf32(False):
        for _ in range(n_iterations):
            recs: list[LayerRecord] = []
            x = x0
            for lid, (layer, gp) in enumerate(zip(layers, grad_params)):
                f_us = _time_call(fwd, layer.apply, layer.params, x, repeats=repeats,
                                  device=device)
                if _leaves(layer.params):
                    xg = x.detach().requires_grad_(x.is_floating_point())
                    b_us = _time_call(bwd, layer.apply, gp, xg, repeats=repeats,
                                      device=device)
                    del xg
                else:
                    b_us = 0.0
                size = _param_bytes(layer.params)
                c_us = comm_time_fn(size) * 1e6 if (comm_time_fn and size) else 0.0
                recs.append(LayerRecord(lid, layer.name, f_us, b_us, c_us, size))
                x = fwd(layer.apply, layer.params, x)
                _block(device)
            iters.append(tuple(recs))
    return Trace(network, cluster, tuple(iters))
