"""What timing the port's kernels on the card shares: the main paths' kernel
shapes, their seeded inputs, the card's name line, the L2-cold timer and
the per-kernel device profile.

``chip_smoke.py`` and :mod:`repro_torch.kernels.compare` both read these, so
a kernel is timed the same way, on the same inputs, by either.  Nothing here
runs on import: the functions need a CUDA device when called.
"""
from __future__ import annotations

import re
import subprocess

import torch


def attn_shape(B, S, H, K, hd, window=None, dtype=torch.bfloat16, causal=True, Skv=None):
    """A flash attention shape: q (B, S, H, hd), k and v (B, Skv, K, hd)
    (``Skv`` defaults to S), the mask (``causal``, ``window``) and the
    dtype; every key present, so that each caller reads them alike."""
    return dict(B=B, S=S, Skv=S if Skv is None else Skv, H=H, K=K, hd=hd, window=window,
                causal=causal, dtype=dtype)


# The main paths' attention shapes at batch_per_gpu 2, seq 1024: qwen1.5-4b's
# G blocks, recurrentgemma-2b's L blocks (window 2048 >= S: causal only),
# gemma3-1b's L blocks (window 512 < S: the window masks) and G blocks.
SLICE = attn_shape(B=2, S=1024, H=20, K=20, hd=128)
# the train_e2e twin's L blocks at its full preset (8 x 256 tokens, f32)
E2E_L = attn_shape(B=8, S=256, H=8, K=1, hd=64, window=64, dtype=torch.float32)
L_BLOCK = attn_shape(B=2, S=1024, H=10, K=1, hd=256, window=2048)
GEMMA3_L = attn_shape(B=2, S=1024, H=4, K=1, hd=256, window=512)
GEMMA3_G = dict(GEMMA3_L, window=None)
# The G blocks of internlm2-20b (and grok-1-314b: 48 query heads on 8 kv
# heads, a group of 6), qwen1.5-32b (40 heads) and qwen2-moe-a2.7b (16
# heads), all at hd 128.
INTERNLM2_G = attn_shape(B=2, S=1024, H=48, K=8, hd=128)
QWEN32_G = dict(INTERNLM2_G, H=40, K=40)
QWEN2MOE_G = dict(INTERNLM2_G, H=16, K=16)
# The encoder-decoder path: whisper-tiny (6 heads of 64, batch 8) over its
# 1500 frames (the encoder: bidirectional, ragged at 1500 = 23 x 64 + 28),
# its 448-token text context (the decoder's causal self-attention) and the
# decoder's cross-attention to the frames; llama-3.2-vision-90b (64 heads
# on 8 kv heads of 128) at 4096 tokens, its G blocks and its C blocks'
# cross-attention to 1601 image tokens, in training and at one query token
# (decode, batch 4).
WHISPER_ENC = attn_shape(B=8, S=1500, H=6, K=6, hd=64, causal=False)
WHISPER_DEC = attn_shape(B=8, S=448, H=6, K=6, hd=64)
WHISPER_CROSS = attn_shape(B=8, S=448, Skv=1500, H=6, K=6, hd=64, causal=False)
LLAMA_G = attn_shape(B=1, S=4096, H=64, K=8, hd=128)
LLAMA_CROSS = attn_shape(B=1, S=4096, Skv=1601, H=64, K=8, hd=128, causal=False)
CROSS_DECODE = attn_shape(B=4, S=1, Skv=1601, H=64, K=8, hd=128, causal=False)
#: labels of the shapes whose path runs the forward alone: decode's
#: cross-attention at one token, under ``torch.no_grad`` (no o32)
FORWARD_ONLY = ("cross_decode",)
# rwkv6-1.6b's wkv shape at batch_per_gpu 2, seq 1024 (32 heads of 64).
WKV6_SLICE = dict(B=2, S=1024, H=32, hd=64, dtype=torch.bfloat16)
# recurrentgemma-2b's RG-LRU shape at batch_per_gpu 2, seq 1024 (W = rnn_width).
RGLRU_SLICE = dict(B=2, S=1024, W=2560, dtype=torch.bfloat16)

#: GPU cycles (~2 ms) the stream sleeps before a timed run, so that the
#: host has queued the launches ahead of the device: a kernel shorter than
#: its wrapper's host time is timed on the device, not on the host.
QUEUE_AHEAD_CYCLES = 4_000_000


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def make_inputs(B, S, H, K, hd, dtype, Skv=None, seed=0, **_):
    """q, k, v, do for flash attention: N(0, 1) in ``dtype`` on the card;
    k and v of ``Skv`` rows (S by default)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(dtype)  # noqa: E731
    Skv = S if Skv is None else Skv
    return mk(B, S, H, hd), mk(B, Skv, K, hd), mk(B, Skv, K, hd), mk(B, S, H, hd)


def rglru_inputs(B, S, W, dtype, h0=False, r_shift=0.0, lam=None, seed=0, **_):
    """x, r, i, dout (B, S, W) in ``dtype``; lam = linspace(0.1, 2, W) as
    the model's init, or ``lam`` in every lane (20: a ~ e^-160 sigmoid(r),
    so the decay products underflow to 0); h0 and dh_last (B, W) f32 (h0
    None unless asked)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, r, i, dout = (torch.randn(B, S, W, generator=g, device="cuda") for _ in range(4))
    lam = torch.linspace(0.1, 2.0, W, device="cuda") if lam is None else \
        torch.full((W,), float(lam), device="cuda")
    h_0 = torch.randn(B, W, generator=g, device="cuda") if h0 else None
    dh_last = torch.randn(B, W, generator=g, device="cuda")
    return (x.to(dtype), (r + r_shift).to(dtype), i.to(dtype), lam, h_0, dout.to(dtype),
            dh_last)


def wkv6_inputs(B, S, H, hd, dtype, state=False, decay="mild", seed=0, **_):
    """r, k (0.5 N(0, 1)), v, w, dout (B, S, H, hd) in ``dtype``; u (H, hd)
    0.3 N(0, 1) f32; the state (B, H, hd, hd) f32 (None unless asked) and
    a final-state cotangent ds_last (B, H, hd, hd) f32.  ``decay``: "mild"
    exp(-exp(N(0, 1) - 3)) as the repository's kernel tests, "strong" w
    uniform in [1e-3, 0.2], "one" exp(-exp(N(0, 1) - 12)), which bfloat16
    rounds to exactly 1.0 (checked here), "zero" the strong decays with a
    quarter of the entries set to exactly 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    r, k, v, dout = 0.5 * mk(B, S, H, hd), 0.5 * mk(B, S, H, hd), mk(B, S, H, hd), \
        mk(B, S, H, hd)
    if decay in ("strong", "zero"):
        w = 1e-3 + (0.2 - 1e-3) * torch.rand(B, S, H, hd, generator=g, device="cuda")
        if decay == "zero":
            w = w.masked_fill(torch.rand(w.shape, generator=g, device="cuda") < 0.25, 0.0)
    else:
        w = torch.exp(-torch.exp(mk(B, S, H, hd) - (12.0 if decay == "one" else 3.0)))
    u = 0.3 * mk(H, hd)
    st = mk(B, H, hd, hd) if state else None
    ds_last = mk(B, H, hd, hd)
    r, k, v, w, dout = (t.to(dtype) for t in (r, k, v, w, dout))
    if decay == "one" and not bool((w == 1.0).all()):
        raise ValueError("the w = 1 shape does not round w to 1.0")
    return r, k, v, w, u, st, dout, ds_last


def time_ms(fn, iters=20) -> float:
    """Mean device time of one call of ``fn``, with the 50 MB L2 refilled
    before each call by reading 64 MB (a read leaves no dirty lines to
    write back during the timed call) and only the calls timed: the time
    of a call whose inputs come from device memory, not from L2, as on the
    main path, where a layer's activations do not stay in L2 between its
    forward and its backward."""
    flush = torch.ones(16 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


def device_times(fn) -> dict[str, float]:
    """Device milliseconds per CUDA kernel name over one call of ``fn``
    (after a warm-up call), from ``torch.profiler`` with CUDA activities;
    empty when the profiler records no device event."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.device_time_total / 1e3
    return out


#: the port's own CUDA kernels, as the profiler names them
PORT_KERNEL = re.compile(r"void \(anonymous namespace\)::(flash|rglru|wkv6)_")


def print_profile(label: str, times: dict[str, float], top: int = 12) -> None:
    """The ``top`` kernels by device time and every one of the port's own
    kernels, the rest summed, and the total."""
    if not times:
        print(f"  {label}: the profiler recorded no device time", flush=True)
        return
    ranked = sorted(times.items(), key=lambda kv: -kv[1])
    total = sum(times.values())
    print(f"  {label}: device {total:.4f} ms in {len(times)} kernels", flush=True)
    shown = ranked[:top] + [kv for kv in ranked[top:] if PORT_KERNEL.match(kv[0])]
    for name, ms in shown:
        print(f"    {ms:9.4f} ms {100 * ms / total:5.1f} %  {name[:110]}", flush=True)
    if len(ranked) > len(shown):
        rest = total - sum(ms for _, ms in shown)
        print(f"    {rest:9.4f} ms {100 * rest / total:5.1f} %  ({len(ranked) - len(shown)} "
              f"more)", flush=True)
