"""What the port's kernels cost, and what the card offers: one copy for the
kernels' FLOP formulas (:mod:`torch.utils.flop_counter`), the kernels'
bounds in ``chip_smoke.py`` and the roofline (:mod:`repro_torch.launch.
roofline`).

The peaks are NVIDIA's data-sheet numbers for one H100 SXM (NVIDIA H100
80GB HBM3) at its full 700 W power limit, not measurements: HBM bytes/s,
dense FLOP/s by input type (bfloat16 on the tensor cores, float32 on the
CUDA cores), and NVLink 4's rate in one direction (900 GB/s both ways).
A card set below 700 W runs slower under load.

FLOPs count the matrix products (and, for the two scans, the recurrence's
arithmetic) over what the data needs: the (query, key) pairs the mask lets
through, as :func:`visible_pairs` counts them in closed form (no mask is
built, so a 524 288-token shape costs nothing to price).  The scans follow
``archcost._attention_flops_fwd`` for their block kinds (``W`` 4 B S hd d,
``R`` 8 B S W a forward) with the backward at 2x the forward, the
convention of that module's ``step_cost`` (train = 3x forward).  The
bounds (:func:`bounds`, :func:`rglru_bounds`, :func:`wkv6_bounds`) count
the scans' float32 operations from the kernels instead (21 / 38 an element
and step for the RG-LRU, 5 / 14 a state entry for wkv6), the least work
the card must do.
"""
from __future__ import annotations

import torch

#: HBM bytes/s of one H100 SXM at 700 W (data sheet)
PEAK_BYTES_PER_S = 3.35e12
#: dense FLOP/s by input type: bfloat16 on the tensor cores, float32 on the
#: CUDA cores (data sheet, 700 W)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: NVLink 4 bytes/s in one direction (900 GB/s both ways; data sheet)
NVLINK_BYTES_PER_S = 450e9


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the mask lets through for one (batch, head):
    query i sees key j when ``j <= i`` (``causal``) and ``j > i - window``
    (a window).  A causal or windowed mask needs ``Sq == Skv`` (the
    kernels' rule)."""
    if not causal and window is None:
        return Sq * Skv
    if Sq != Skv:
        raise ValueError(f"a causal or windowed mask needs Sq == Skv, got {Sq}, {Skv}")
    S = Sq
    w = S if window is None else min(int(window), S)
    if causal:   # sum over i of min(i + 1, w)
        return w * (w + 1) // 2 + (S - w) * w
    # query i sees keys max(0, i - w + 1) .. S - 1
    return S * S - (S - w) * (S - w + 1) // 2


def flash_flops(B: int, S: int, Skv: int, H: int, hd: int, causal: bool,
                window: int | None) -> dict[str, float]:
    """Matrix-product FLOPs of each flash kernel: 4 (forward: QK^T, PV), 6
    (dq: dO V^T, dS K and the recomputed QK^T) and 8 (dk/dv) x the visible
    pairs x hd; delta = rowsum(dO * O) 2 B S H hd."""
    pairs = float(visible_pairs(S, Skv, causal, window)) * B * H
    return {"flash_fwd": 4 * pairs * hd, "flash_bwd_delta": 2.0 * B * S * H * hd,
            "flash_bwd_dq": 6 * pairs * hd, "flash_bwd_dkdv": 8 * pairs * hd}


def rglru_flops(B: int, S: int, W: int) -> dict[str, float]:
    """``archcost``'s ``R`` term, 8 B S W a forward; the backward 2x."""
    fwd = 8.0 * B * S * W
    return {"rglru_fwd": fwd, "rglru_bwd": 2 * fwd}


def wkv6_flops(B: int, S: int, H: int, hd: int) -> dict[str, float]:
    """``archcost``'s ``W`` term, 4 B S hd d (d = H hd) a forward; the
    backward 2x."""
    fwd = 4.0 * B * S * H * hd * hd
    return {"wkv6_fwd": fwd, "wkv6_bwd": 2 * fwd}


def _least_ms(work: dict, peak: float) -> dict:
    """name -> (max(ops / peak, bytes / HBM rate) in ms, what binds)."""
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes")
    return out


def bounds(B, S, Skv, H, K, hd, window, causal, dtype, train=True, **_) -> dict:
    """Least time per flash kernel at this shape: max(bytes / HBM rate,
    FLOPs / peak rate for the input type).  FLOPs are :func:`flash_flops`
    (exp and the elementwise work are left out); bytes count each input
    read once and each output written once (q-side tensors of S rows, k and
    v of Skv).  ``train``: the calls as training makes them, where in
    bfloat16 the forward also writes its float32 output (o32) and delta
    reads that."""
    flops = flash_flops(B, S, Skv, H, hd, causal, window)
    es = torch.finfo(dtype).bits // 8
    qb, kb, stat = B * S * H * hd * es, B * Skv * K * hd * es, B * H * S * 4
    o32 = B * S * H * hd * 4 if train and dtype == torch.bfloat16 else 0
    nbytes = {"flash_fwd": qb + 2 * kb + qb + stat + o32,
              "flash_bwd_delta": qb + (o32 or qb) + stat,
              "flash_bwd_dq": 2 * qb + 2 * kb + 2 * stat + qb,
              "flash_bwd_dkdv": 2 * qb + 2 * kb + 2 * stat + 2 * kb}
    return _least_ms({n: (flops[n], nbytes[n]) for n in flops}, PEAK_FLOPS[dtype])


def rglru_bounds(B, S, W, dtype, h0=False, save=True, **_) -> dict:
    """Least time per RG-LRU kernel at this shape, as on the training path
    (no h0; the forward saves the f32 states; autograd hands the backward
    a zero dh_last) or, with ``h0`` and not ``save``, as in decode (reads
    h0, saves nothing): bytes count each input read once and each output
    written once; operations are the scan's float32 arithmetic per element
    and step (21 forward, 38 backward, counted from the kernels) at the
    CUDA cores' float32 rate."""
    n, es = B * S * W, torch.finfo(dtype).bits // 8
    work = {  # name: (float32 operations, bytes)
        "rglru_fwd": (21 * n, 3 * n * es + W * 4 + n * es + B * W * 4 + n * 4 * save
                      + B * W * 4 * h0),
        "rglru_bwd": (38 * n, 4 * n * es + W * 4 + n * 4 + B * W * 4 + 3 * n * es + W * 4
                      + B * W * 4),
    }
    return _least_ms(work, PEAK_FLOPS[torch.float32])


def wkv6_bounds(B, S, H, hd, dtype, state=False, save=True, **_) -> dict:
    """Least time per wkv6 kernel at this shape, as on the training path (no
    initial state; the forward saves the checkpoints; autograd hands the
    backward a zero final-state cotangent) or, with ``state`` and not
    ``save``, as in decode (reads the state, keeps no checkpoint): bytes
    count each input read
    once and each output written once; operations are the float32
    arithmetic the function needs, at the CUDA cores' float32 rate.
    Forward: 5 per state entry and step (the r^T S FMA, the decay multiply,
    the k v FMA) plus 5 per channel and step for the u bonus, taken as
    (r . (u * k)) v_t. Backward: 14 per state entry and step (dr, dk and dw
    FMAs, the dv product and its sum, the cotangent update, and rebuilding
    S_{t-1} once)."""
    from repro_torch.kernels.wkv6 import num_checkpoints

    n, es = B * S * H * hd, torch.finfo(dtype).bits // 8
    state_b, u = B * H * hd * hd * 4, H * hd * 4
    ckpt, entries = num_checkpoints(S) * state_b, B * H * S * hd * hd
    work = {  # name: (float32 operations, bytes)
        "wkv6_fwd": (5 * entries + 5 * n,
                     4 * n * es + u + n * es + state_b + ckpt * save + state_b * state),
        "wkv6_bwd": (14 * entries, 5 * n * es + u + ckpt + state_b + 4 * n * es + u + state_b),
    }
    return _least_ms(work, PEAK_FLOPS[torch.float32])
