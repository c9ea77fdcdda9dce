"""Least time of each flash-attention and wkv6 kernel at one shape: the larger
of its operations over the peak rate and its bytes over the HBM rate.

Operations count what the data needs: the (query, key) pairs a causal mask
lets through times 4 (forward), 6 (dq) and 8 (dk/dv) x hd on the tensor
cores; for wkv6 the float32 arithmetic of the scan on the CUDA cores, 5 per
state entry and step plus 5 per channel forward, 14 per state entry and
step backward.  Bytes count each input read once and each output written
once, with the float32 side outputs the training path keeps (flash's f32
output o32, wkv6's chunk-start states every ``WKV6_CHECKPOINT`` steps)."""
from __future__ import annotations

from bench.cost.peaks import BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S

#: steps between the wkv6 forward's saved f32 states
WKV6_CHECKPOINT = 64


def causal_pairs(S: int) -> int:
    """(query, key) pairs with key <= query in one (batch, head)."""
    return S * (S + 1) // 2


def _least_s(ops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def flash_least_s(B: int, S: int, H: int, K: int, hd: int,
                  elem_bytes: int = 2) -> dict[str, tuple[float, str]]:
    """kernel -> (least seconds, what binds) for causal self-attention over
    (B, S) with H query heads on K kv heads of size hd, as training calls
    it in bfloat16 (the forward also writes o32, which delta reads)."""
    pairs = float(causal_pairs(S)) * B * H
    qb, kb, stat = B * S * H * hd * elem_bytes, B * S * K * hd * elem_bytes, B * H * S * 4
    o32 = B * S * H * hd * 4
    work = {"flash_fwd": (4 * pairs * hd, qb + 2 * kb + qb + stat + o32),
            "flash_bwd_delta": (2.0 * B * S * H * hd, qb + o32 + stat),
            "flash_bwd_dq": (6 * pairs * hd, 2 * qb + 2 * kb + 2 * stat + qb),
            "flash_bwd_dkdv": (8 * pairs * hd, 2 * qb + 2 * kb + 2 * stat + 2 * kb)}
    return {name: _least_s(ops, nbytes, BF16_FLOPS) for name, (ops, nbytes) in work.items()}


def wkv6_least_s(B: int, S: int, H: int, hd: int,
                 elem_bytes: int = 2) -> dict[str, tuple[float, str]]:
    """kernel -> (least seconds, what binds) for the wkv6 scan over (B, S, H,
    hd) as training calls it: no initial state, the forward keeps its
    chunk-start states, the backward gets a zero final-state cotangent."""
    n = B * S * H * hd
    state, u = B * H * hd * hd * 4, H * hd * 4
    ckpt = -(-S // WKV6_CHECKPOINT) * state
    entries = B * H * S * hd * hd
    work = {"wkv6_fwd": (5 * entries + 5 * n, 4 * n * elem_bytes + u + n * elem_bytes
                         + state + ckpt),
            "wkv6_bwd": (14 * entries, 5 * n * elem_bytes + u + ckpt + state
                         + 4 * n * elem_bytes + u + state)}
    return {name: _least_s(ops, nbytes, F32_FLOPS) for name, (ops, nbytes) in work.items()}
