"""Calibration: payload accounting, the bytes cross-check and the
alpha-beta fit.

Counterpart of :mod:`repro.measure.calibrate`.  The reference
cross-checks HLO-harvested collective bytes; the port counts the bytes
actually handed to ``all_reduce`` (:class:`repro_torch.comm.sync.Comm`)
and checks them against :func:`expected_collective_bytes`.
:func:`fit_alpha_beta` and :func:`comm_scale_from_fit` are copies of the
reference's, pinned to them by a CPU test.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig

#: f32 scalar all-reduces the ddp step issues besides the gradient sync:
#: the means of ``total_loss`` and ``loss``.
METRIC_COLLECTIVE_BYTES = 8.0


def cluster_name(device_type: str, backend: str, n_ranks: int) -> str:
    """Cluster name recorded in measured traces, e.g. ``torch-cuda-gloo-x2``
    (the reference records ``jax-host-cpu-x<N>``)."""
    return f"torch-{device_type}-{backend}-x{n_ranks}"


def _param_shapes(cfg: ModelConfig):
    return T.leaf_order(T.init_lm(cfg, device="meta"))


def grad_payload_bytes(cfg: ModelConfig) -> tuple[float, float]:
    """``(per_unit_bytes, rest_bytes)``: gradient all-reduce payload of one
    scanned unit and of the non-scanned leaves, in the parameter dtype —
    from shapes on the meta device, no allocation."""
    unit_bytes = 0.0
    rest_bytes = 0.0
    for path, leaf in _param_shapes(cfg):
        nbytes = float(leaf.numel() * leaf.element_size())
        if path[0] == "units":
            unit_bytes += nbytes / max(cfg.num_units, 1)
        else:
            rest_bytes += nbytes
    return unit_bytes, rest_bytes


def expected_collective_bytes(cfg: ModelConfig, sync_policy: str) -> float:
    """Bytes one step of the ddp step hands to ``all_reduce`` under
    ``sync_policy``: every gradient once in its own dtype (``at_end``,
    ``wfbp``) or in f32 (``bucketed``, which concatenates in f32), plus the
    two scalar metric means."""
    if sync_policy not in ("at_end", "wfbp", "bucketed"):
        raise ValueError(f"unknown sync policy {sync_policy!r}")
    total = 0.0
    for _, leaf in _param_shapes(cfg):
        itemsize = 4.0 if sync_policy == "bucketed" else float(leaf.element_size())
        total += float(leaf.numel()) * itemsize
    return total + METRIC_COLLECTIVE_BYTES


def fit_alpha_beta(samples: Sequence[tuple[float, float]],
                   ) -> tuple[float, float]:
    """Least-squares ``t = alpha + nbytes / beta`` over ``(payload bytes,
    seconds)`` samples; returns ``(latency_s, bandwidth_bytes_per_s)``.
    Repeated payloads collapse to their minimum; one distinct payload pins
    latency to 0; no samples give ``(0, inf)``; a non-positive slope gives
    infinite bandwidth and a negative intercept clamps to 0."""
    best: dict[float, float] = {}
    for b, t in samples:
        b, t = float(b), float(t)
        if b > 0 and t > 0:
            best[b] = min(t, best.get(b, t))
    if not best:
        return 0.0, float("inf")
    if len(best) == 1:
        (b, t), = best.items()
        return 0.0, b / t
    xs = np.array(sorted(best))
    ys = np.array([best[b] for b in xs])
    slope, icpt = np.polyfit(xs, ys, 1)
    bandwidth = 1.0 / slope if slope > 0 else float("inf")
    return max(float(icpt), 0.0), float(bandwidth)


def comm_scale_from_fit(latency_s: float, bandwidth_bytes_per_s: float,
                        ) -> Callable[[float, float], float]:
    """A ``comm_scale(total_bytes, naive_time) -> seconds`` closure from a
    measured alpha-beta fit."""

    def scale(total_bytes: float, _naive_time: float) -> float:
        if total_bytes <= 0:
            return 0.0
        return latency_s + total_bytes / bandwidth_bytes_per_s

    return scale
