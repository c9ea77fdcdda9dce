"""Drives the port on one NVIDIA H100: ``python3 chip_smoke.py``.

Phases, in order; any failure ends the script with a non-zero code:

1. print the card's name and power limit (``nvidia-smi``);
2. build every kernel library from ``src/repro_torch/csrc`` (flash
   attention, RG-LRU and wkv6, one ``nvcc`` each, at once); print the flash
   forward and backward kernels' ``-Xptxas -v`` lines, each bfloat16
   tensor-core instantiation's registers, shared memory and CTAs per SM,
   and their HMMA count in the SASS, and one line summing the float32 FMA
   kernels' spills (fails on a tensor-core kernel's spill or one without
   HMMA); print every RG-LRU and wkv6 kernel's ``-Xptxas
   -v`` lines and the bfloat16 instantiations' registers, shared memory and
   CTAs per SM (fails on a spill);
3. hold every flash kernel (forward, delta, dq, dk/dv) against its plain
   PyTorch version on the card, element by element, at qwen1.5-4b's
   shape, at recurrentgemma-2b's local-attention shape (hd 256, one KV
   head), at gemma3-1b's two shapes (hd 256, one KV head, window 512 under
   1024 tokens, and no window), at the hd 128 shapes of internlm2-20b's
   (48 query heads on 8 kv heads: a group of 6), qwen1.5-32b's (40 heads)
   and qwen2-moe-a2.7b's (16 heads) G blocks, and at a GQA + window (hd 256)
   shape in bfloat16 and in float32,
   and at a ragged and two more float32 shapes, and in bfloat16 at hd 64,
   hd 32 ragged and hd 256 ragged with two kv heads (the tensor-core
   backward's other instantiations), and at the encoder-decoder path's
   shapes (whisper-tiny's bidirectional encoder over 1500 frames, its
   448-token causal decoder and its cross-attention to the frames,
   llama-3.2-vision-90b's G blocks at 4096 tokens and its cross-attention
   to 1601 image tokens, that at one query token forward only, and in
   float32 a cross shape ragged on both sides and a bidirectional one);
   hold the differentiable attention against autograd through
   ``ref.attention`` (causal, windowed, bidirectional and cross); hold the RG-LRU
   forward against its plain version and its backward against autograd
   through ``ref.rglru``, at recurrentgemma-2b's shape in bfloat16 and
   float32, at a ragged shape with a carried state, where sigmoid(r) ~ 0,
   with a ragged last chunk in bfloat16, a sequence shorter than one chunk
   at an odd width, and where the chunks' decay products underflow to 0;
   hold the wkv6 forward against its plain version and its backward
   against autograd through ``ref.wkv6``, at rwkv6-1.6b's shape in bfloat16
   and float32, at a ragged shape (hd 32) with a carried state, at strong
   decays (w down to 1e-3), where bfloat16 rounds w to exactly 1 and with w
   exactly 0 in a quarter of the entries; hold a reduced qwen1.5-4b's,
   recurrentgemma-2b's, rwkv6-1.6b's, gemma3-1b's, qwen2-moe-a2.7b's (8
   experts, top-4, shared experts), grok-1-314b's (8 experts, top-2),
   internlm2-20b's, whisper-tiny's (C blocks and the encoder) and
   llama-3.2-vision-90b's (GC) loss and gradients on the card
   (through the kernels, run twice and required bitwise equal) against the
   same model on the CPU (plain versions); run the bfloat16 flash forward
   and backward, the RG-LRU forward and backward and the wkv6 forward and
   backward twice at the main paths' shapes (flash also at gemma3-1b's
   windowed one, at internlm2-20b's group of 6 and at whisper-tiny's
   cross-attention) and require bitwise-equal outputs;
4. time each kernel, its plain version and the PyTorch library call that
   computes the same function (``scaled_dot_product_attention`` and its
   backward, with a boolean band mask on the first backend that takes it
   where the window is shorter than the sequence; ``torch.linalg.vecdot``
   for delta; ``is_causal=False`` with ``enable_gqa`` for the bidirectional
   and cross shapes; timed here only and never called by the port; none
   for the RG-LRU and wkv6 scans), each with L2 refilled before every call,
   at the main paths' shapes and the encoder-decoder path's, and compute
   each kernel's bound (``repro_torch.kernels.cost``); print the CUDA
   kernels of each RG-LRU and wkv6 wrapper call with their device times
   (``torch.profiler``);
5. profile one unit's forward and backward on each main path at its
   published widths (``torch.profiler``, device time per kernel name);
6. run ``repro_torch.measure`` for qwen1.5-4b (1 unit), recurrentgemma-2b
   (one RRL unit), rwkv6-1.6b (1 unit), gemma3-1b (one LLLLLG unit),
   internlm2-20b (1 unit) and qwen2-moe-a2.7b (1 unit, the MoE MLP) at
   their published widths with 2 gloo ranks on the card, all three sync
   policies and 3 timed steps each (2 for internlm2-20b and
   qwen2-moe-a2.7b); check each written trace, the counted
   all-reduce bytes and that the three policies leave the same momentum;
7. check that every kernel of each path launched during its run (the
   counters are set to 0 before each);
8. model vs measured (the paper's Fig. 4): predict each path's step time
   per sync policy from its trace, ``t_u`` and all-reduce fit with the
   port's copy of the DAG model
   (``repro_torch.measure.model_vs_measured``) and print the error against
   the measured step time (no ceiling: gloo on shared host cores moves the
   steps between runs);
9. sweep on the card: the DAG model's batched sweep backend
   (``repro_torch.core.batched_torch``, float64 torch on CUDA) over the
   frontier grid (51 840 scenarios), over the same axes on the paper CNNs
   plus the six traces this run measured (``torch:`` workloads, 155 520
   scenarios) — each checked against the port's NumPy engine on every
   numeric column (1e-6 relative, 1e-12 absolute), with the result tensors
   checked to be on the card before they are copied back; the two tiers
   (``columns()``) and ``sweep()`` end to end timed against the NumPy path
   (median of 20 after a warm-up, synchronised), scenarios/s printed, the
   CUDA kernels of one evaluation counted (``torch.profiler``), then the
   kernels and aten operators of three more evaluations of each grid, with
   the kernel names whose counts differ between the grids; the
   measured-workloads grid of ``benchmarks/bench_model_vs_measured.py``
   over those traces with its row accounting (0 simulated); and
   ``grad_iteration_time`` on CUDA at two family grids against the CPU
   (1e-9) and against central differences on the NumPy twin (1e-3);
10. the sweep service on the card: ``repro_torch.launch.serve_sweep``'s
   HTTP server over a ``SweepService`` on CUDA, 10 ``backend="torch"``
   queries POSTed at once from their own client threads (the frontier axes
   split by workload, the mixed grid, and one with het, straggler, sync_k
   and fault axes, under seeds 0 and 7), each answer decoded
   (``table_from_wire``) and held against a direct ``sweep()`` on the card
   (bit for bit, or 1e-12 relative) and the NumPy engine (1e-6), with the
   queries each kernel call served, latency p50 / p99, scenarios/s over the
   kernels' busy time and cache hits from the trailers and ``/stats``;
   the frontier axes over the CNNs and this run's traces (155 520
   scenarios) streamed to CSV in chunks of 16 384 and read back equal to
   ``sweep()``; and a small grid (resnet50 and ``trace:alexnet-k80``, all
   ten policies, het, sync_k and fault axes) on the card against the
   event-driven simulator (1e-6), its sub-grids on a process pool;
11. CNN traces (Table VI): the paper's per-layer method on its CNNs.
   AlexNet at 99 x 99 and ResNet at 64 x 64 (one block a stage) on the card
   against the CPU, every layer's forward and gradients in float32 with
   TF32 off, within ``generate.F32_LIMIT`` (2e-5) of each tensor's scale,
   and in TF32, the control, beyond it; then
   ``repro_torch.examples.table6_trace``: Table VI's totals and round trip,
   and fresh traces of AlexNet (224 x 224, batch 1024, 11 layers) and
   ResNet-50 (224 x 224, batch 32, 19 layers) printed per layer after the
   card's name and power limit, written, read back and resolved through
   ``trace:<file>``; at those shapes every layer's forward against float64
   on the card (the same limit and TF32 control), beside its float32 bound
   (a direct convolution's FLOPs from ``torch.utils.flop_counter``, bytes)
   and its kernels
   (``torch.profiler``); each trace predicted on 8 V100s under Caffe-MPI
   beside ``trace:alexnet-k80``;
12. DAG validation (§V-D): ``repro_torch.examples.dag_validation`` with 2
   timed steps a policy (qwen1.5-4b, 2 units, 2 gloo ranks on the card):
   per-layer costs, the DAG's prediction with and without
   ``shared_compute``, the measured ``wfbp`` and ``at_end`` steps, its
   ``RESULT``; the flash kernels must launch (counted from 0 in each rank);
13. decode on the card: qwen1.5-4b (2 ``G``), recurrentgemma-2b (one
   ``RRL`` unit), rwkv6-1.6b (2 ``W``) and gemma3-1b (one ``LLLLLG`` unit)
   at their published widths, batch 4: ``prefill_via_decode`` then greedy
   ``make_serve_step`` steps in float32 (TF32 off), every position's
   logits against one ``forward`` over the same tokens within 2e-4 of
   their scale (gemma3-1b over 600 tokens, past its 512-token window, so
   that the ring buffers wrap); the RG-LRU and wkv6 forward kernels must
   launch at one token with their carried state; then decode timed in
   bfloat16 (tokens/s, port kernel launches and CUDA kernels a step) and
   ``rglru_fwd`` / ``wkv6_fwd`` at one token against their plain versions
   and bounds (phase 3 also holds them at one token, bf16 and f32);
14. the training launcher: ``python -m repro_torch.launch.train --arch
   gemma3-1b --full --optimizer adamw`` (26 layers), 3 steps of 4 x 1024
   tokens with ``--checkpoint``: finite loss, every parameter and optimizer
   leaf restored bit for bit; then ``--data-parallel 2 --policy wfbp`` at
   reduced widths (2 gloo ranks);
15. remat and accumulation: ``make_train_step`` on one gemma3-1b unit at
   the published widths: ``remat=True`` gives the gradient bits of
   ``remat=False`` with the flash forward launched twice as often, and
   ``accum_steps=2`` agrees with one batch within 3e-2 of each leaf's scale;
16. the encoder-decoder on the card: whisper-tiny at its published widths
   and depth (4 + 4 layers) in float32, batch 2 x 64 tokens over 1500
   frames, logits, loss and every gradient leaf on the card against the
   CPU within 2e-4 of scale; 3 bfloat16 ``make_train_step`` steps (AdamW)
   at 8 x 448 tokens, ms a step and peak memory; decode (the encoder
   states once, ``prefill_via_decode``, greedy ``make_serve_step``) in
   float32 against ``forward`` within 2e-4 of the logits' scale, then
   timed in bfloat16 at batch 4 (tokens/s, launches a token);
   llama-3.2-vision-90b at its published widths cut to one GGGGC unit
   (6.53 G parameters): one bfloat16 ``make_train_step`` step (SGD) at 1 x
   4096 tokens and 1601 image tokens, ms and peak memory, and a float32
   decode of 32 tokens against ``forward`` within 2e-4;
17. the dry run against the card: qwen1.5-4b (1 unit), recurrentgemma-2b
   (one RRL unit) and rwkv6-1.6b (1 unit) at their published widths,
   bfloat16, batch 2 x 1024, SGD with momentum 0.9, remat on: one real
   single-rank ``make_train_step`` step, then ``repro_torch.launch.dryrun``
   's lowering of the same step on fake CUDA tensors and on the meta device
   (the two records equal); the real ``max_memory_allocated`` beside the
   dry run's arguments + temporaries (within 10 %), the FLOP totals
   (``FlopCounterMode``, equal) and each kernel operator's calls (equal),
   after the roofline's data-sheet constants and the card's line;
18. train_e2e (deliverable b): ``repro_torch.examples.train_e2e --preset
   full --steps 300 --ckpt-every 100`` (the reference's presets: 12 layers,
   d 512, f32, one kv head of 64, window 64; 8 x 256 tokens): its
   ``report.json``, peak memory, loss curve and kernel launches; fails
   unless the flash forward and dk/dv kernels launched, every loss is
   finite and the reference's own check (the last ten losses' mean below
   the first) holds; then the flash kernels timed at its ``L`` shape
   (``bench.E2E_L``) beside their bounds, plain versions and SDPA with the
   band mask;
19. the sequence-sharded decode: ``repro_torch.launch.seq_decode`` on 2
   gloo ranks at gemma3-1b's and recurrentgemma-2b's published widths and
   full depth, bfloat16, batch 1, a cache of 524 288 tokens (``long_500k``)
   filled from a seeded generator, 4 tokens at positions 524 284-524 287:
   each rank's logits and cache against the one-rank decode on the same
   cache, and each attention layer's combine on the one-rank decode's
   inputs against that layer's one-rank output, within 3e-2 of each one's
   own scale (the bf16 ``_tol``); the control, a combine that drops the
   other rank's partials, must exceed that limit on some rank at every
   token; host ms a token, and the bytes and calls its ``Comm`` counted a
   token, which must equal the dry run's ``long_500k`` / ``dp8`` record for
   the arch; recurrentgemma-2b's sharded decodes must launch ``rglru_fwd``
   at one token;
20. the sharded step (zero3): ``repro_torch.launch.sharded_step`` on 2 gloo
   ranks of this card on ``dp2`` under ``zero3``, bfloat16, 2 x 1024 tokens
   a rank, SGD with momentum 0.9, remat, for recurrentgemma-2b at one
   ``RRL`` unit of its published widths and rwkv6-1.6b at one layer: each
   rank holds its shards of the parameters and momentum, gathers a unit's
   when it runs and reduce-scatters its gradients; the gathered parameters
   and momentum against the ``pure_dp`` step from the same parameters and
   batch leaf by leaf within ``MOMENTUM_RTOL`` of each leaf's scale, the
   loss and ``grad_norm`` too; the control, which skips the division by the
   world size, beyond it; the collectives' calls and bytes by op equal to
   the dry run's (``repro_torch.launch.dryrun.lower`` of the same config,
   mesh and mode) and rank 0's peak within ``DRYRUN_PEAK_RTOL`` of its
   arguments + temporaries; both archs' kernels launched;
21. the sharded step (fsdp): the same on 4 gloo ranks of this card on
   ``{data: 2, model: 2}``, 2 x 1024 tokens a ``data`` rank, with tensor
   and expert parallelism on ``model`` (``repro_torch.comm.
   tensor_parallel``): recurrentgemma-2b at one ``RRL`` unit under
   ``fsdp`` (flash on 5 of its 10 q heads a rank beside the one replicated
   kv head, the RG-LRU at width 1280, the tied vocab-parallel embedding),
   rwkv6-1.6b at one layer under ``fsdp`` (wkv6 on 16 of 32 heads, a
   vocab-split head), qwen2-moe-a2.7b at one layer under ``pure_dp`` (30
   of its 60 experts a rank, flash on 8 of 16 heads, ``at_end`` over
   ``data``); each in float32 against ``pure_dp`` on the same rows from
   the same parameters (``dp2``, repeated on the ``model`` ranks) within
   ``F32_LIMIT`` of each leaf's scale, the control beyond it, the counts
   the dry run's, rank 0's peak within ``DRYRUN_PEAK_RTOL``, every rank
   launching its arch's kernels; then in bfloat16 (``sharded_step``'s
   witness): the mode's and ``pure_dp``'s momentum each against the
   float32 ``pure_dp``'s, the mode's distance at most ``WITNESS_RATIO``
   times ``pure_dp``'s, since in bfloat16 the partial sums over ``model``
   round unlike one product, and its counts and peak against the
   bfloat16 dry run's;
22. print the ``kernels`` line (launches: the six measurements', the
   validation's, the float32 decode's, the training launcher's, the
   encoder-decoder phase's, the dry-run phase's real steps, train_e2e's,
   the sequence-sharded decode's and both sharded steps'), then the
   ``ok`` line last.

A failing phase prints ``== <phase>: FAILED`` and its traceback on stdout
before the script exits non-zero.

It imports nothing of JAX and nothing of the reference package ``repro``.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the port first: without it (the script alone) the import fails, nothing is printed
# the card's data-sheet peaks and the kernels' bounds (repro_torch.kernels.cost)
from repro_torch.kernels.cost import (  # noqa: E402
    NVLINK_BYTES_PER_S, PEAK_BYTES_PER_S, PEAK_FLOPS, bounds, rglru_bounds, wkv6_bounds)
from repro_torch.kernels.bench import (  # noqa: E402
    CROSS_DECODE, E2E_L, FORWARD_ONLY, GEMMA3_G, GEMMA3_L, INTERNLM2_G, L_BLOCK, LLAMA_CROSS, LLAMA_G,
    QWEN2MOE_G, QWEN32_G, RGLRU_SLICE, SLICE, WHISPER_CROSS, WHISPER_DEC, WHISPER_ENC,
    WKV6_SLICE, attn_shape, card_line, device_times, make_inputs, print_profile, rglru_inputs, time_ms,
    wkv6_inputs)

#: Element-wise limits (rtol, atol): |got - want| <= rtol * |want| + atol *
#: rms(want), by the output's dtype.  Kernel and plain version both compute
#: in float32, so in bfloat16 they differ by at most one rounding step of the
#: output (2^-7 of the value; readings of 3.9e-3 abs at values in [0.5, 1));
#: atol only keeps entries at zero from dividing by zero.  float32: the
#: repository's f32 kernel tolerance (tests/test_kernels.py ``_tol``).
LIMITS = {torch.bfloat16: (1e-2, 1e-3), torch.float32: (2e-4, 2e-4)}
#: Autograd through the kernels in bfloat16 against autograd through
#: ``ref.attention`` in float32 on the same values: the outputs are rounded
#: to bfloat16 once, and the backward sums in its own order.  delta =
#: rowsum(dO * O) reads the forward's float32 output: from the output
#: rounded to bfloat16 it would put an error in dq and dk that is not
#: proportional to each entry, which in the short causal rows of a
#: 4096-token sequence read 1.41 of this limit.
AUTOGRAD_BF16_LIMIT = (1e-2, 1e-1)
#: Per-leaf norm of the f32 momentum after the timed steps: the three
#: policies agree to bf16 reduction rounding (at_end and wfbp reduce bf16
#: gradients, bucketed f32); a leaf left unsynchronized holds one rank's own
#: gradient instead of the mean over both shards.
MOMENTUM_RTOL = 1e-2
#: A library call timed beside a kernel must compute the kernel's function:
#: its output is held to the kernel's with (rtol, atol) as
#: ``AUTOGRAD_BF16_LIMIT`` (SDPA's kernels round P to bfloat16 before P V, an
#: error the port's hi + lo split avoids); a mask it ignored would put whole
#: rows off by the order of rms(o).
LIBRARY_LIMIT = (1e-2, 1e-1)

# The main paths' attention shapes: ``SLICE`` (qwen1.5-4b's G blocks),
# ``L_BLOCK`` (recurrentgemma-2b's L blocks), ``GEMMA3_L`` and ``GEMMA3_G``
# (gemma3-1b's L and G blocks), ``INTERNLM2_G``, ``QWEN32_G`` and
# ``QWEN2MOE_G`` (the G blocks of internlm2-20b and grok-1-314b, of
# qwen1.5-32b and of qwen2-moe-a2.7b), and the encoder-decoder path's
# (whisper-tiny's encoder, decoder and cross-attention, llama-3.2-vision-90b's
# G blocks and cross-attention, in training and at one query token), from
# ``repro_torch.kernels.bench``.  Every entry carries ``causal`` and
# ``Skv`` (``bench.attn_shape``).
CHECK_SHAPES = [
    ("slice", SLICE),
    ("l_block", L_BLOCK),
    ("f32_l_block", dict(L_BLOCK, dtype=torch.float32)),
    ("gqa_window", attn_shape(B=1, S=2048, H=4, K=1, hd=256, window=512)),
    ("ragged", attn_shape(B=2, S=1000, H=8, K=4, hd=128)),
    ("f32_slice", dict(SLICE, dtype=torch.float32)),
    ("f32_gqa_window", attn_shape(B=1, S=2048, H=4, K=1, hd=256, window=512,
                                  dtype=torch.float32)),
    ("f32_hd64", attn_shape(B=2, S=512, H=4, K=2, hd=64, window=100, dtype=torch.float32)),
    ("f32_hd32_ragged", attn_shape(B=1, S=300, H=2, K=1, hd=32, window=32,
                                   dtype=torch.float32)),
    # train_e2e's L and G blocks: float32, hd 64, a GQA group of 8
    ("e2e_l", E2E_L),
    ("e2e_g", dict(E2E_L, window=None)),
    # the bfloat16 backward's tensor-core instantiations the shapes above
    # leave out: hd 64, hd 32 ragged, hd 256 ragged with two kv heads
    ("hd64", attn_shape(B=2, S=512, H=4, K=2, hd=64, window=100)),
    ("hd32_ragged", attn_shape(B=1, S=300, H=2, K=1, hd=32, window=32)),
    ("hd256_ragged_gqa", attn_shape(B=1, S=1000, H=8, K=2, hd=256)),
    # gemma3-1b's main-path shapes: L blocks (window 512 < S) and G blocks
    ("gemma3_l", GEMMA3_L),
    ("gemma3_g", GEMMA3_G),
    # hd 128 at 48 query heads on 8 kv heads (a group of 6), 40 and 16 heads
    ("internlm2_g", INTERNLM2_G),
    ("qwen32_g", QWEN32_G),
    ("qwen2moe_g", QWEN2MOE_G),
    # the encoder-decoder path: bidirectional (ragged at 1500), causal at
    # hd 64, cross-attention with Sq != Skv (also at one query token,
    # forward only), a GQA group of 8 at 4096 tokens; and in float32, ragged
    # on both sides and bidirectional
    ("whisper_enc", WHISPER_ENC),
    ("whisper_dec", WHISPER_DEC),
    ("whisper_cross", WHISPER_CROSS),
    ("llama_g", LLAMA_G),
    ("llama_cross", LLAMA_CROSS),
    ("cross_decode", CROSS_DECODE),
    ("f32_cross_ragged", attn_shape(B=2, S=100, Skv=300, H=4, K=2, hd=64, causal=False,
                                    dtype=torch.float32)),
    ("f32_noncausal", attn_shape(B=1, S=1000, H=4, K=4, hd=32, causal=False,
                                 dtype=torch.float32)),
]
#: shapes also held through autograd against ``ref.attention``
AUTOGRAD_SHAPES = ("slice", "l_block", "gqa_window", "f32_slice", "f32_l_block",
                   "f32_gqa_window", "whisper_enc", "whisper_dec", "whisper_cross", "llama_g",
                   "llama_cross", "f32_cross_ragged", "f32_noncausal", "e2e_l", "e2e_g")
# The scans in decode: one token with a carried state, batch 4, at
# recurrentgemma-2b's width and rwkv6-1.6b's heads.
RGLRU_DECODE = dict(B=4, S=1, W=2560, dtype=torch.bfloat16, h0=True)
WKV6_DECODE = dict(B=4, S=1, H=32, hd=64, dtype=torch.bfloat16, state=True)
# recurrentgemma-2b's RG-LRU shape (``RGLRU_SLICE``) and others; ``lam``
# and ``r_shift`` as in ``bench.rglru_inputs``.
RGLRU_SHAPES = [
    ("slice", RGLRU_SLICE),
    ("f32_slice", dict(RGLRU_SLICE, dtype=torch.float32)),
    ("f32_ragged_h0", dict(B=2, S=1000, W=200, dtype=torch.float32, h0=True)),
    ("f32_a_near_1", dict(B=2, S=1024, W=256, dtype=torch.float32, h0=True, r_shift=-40.0)),
    # the chunked scan's edges: a ragged last chunk in bfloat16, a sequence
    # shorter than one chunk (odd W: the one-lane kernels), decay products
    # that underflow to exactly 0
    ("ragged", dict(B=2, S=1000, W=2560, dtype=torch.bfloat16, h0=True)),
    ("f32_short_odd_w", dict(B=2, S=20, W=201, dtype=torch.float32, h0=True)),
    ("f32_strong_decay", dict(B=2, S=1000, W=256, dtype=torch.float32, h0=True, lam=20.0)),
    # decode: one token with a carried state, at recurrentgemma-2b's width
    ("decode", RGLRU_DECODE),
    ("f32_decode", dict(RGLRU_DECODE, dtype=torch.float32)),
]
# rwkv6-1.6b's wkv shape (``WKV6_SLICE``) and others; ``decay`` as in
# ``bench.wkv6_inputs``.
WKV6_SHAPES = [
    ("slice", WKV6_SLICE),
    ("f32_slice", dict(WKV6_SLICE, dtype=torch.float32)),
    ("f32_ragged_state", dict(B=2, S=1000, H=4, hd=32, dtype=torch.float32, state=True)),
    ("f32_strong_decay", dict(B=2, S=1024, H=4, hd=64, dtype=torch.float32, decay="strong")),
    ("w_one", dict(B=2, S=512, H=4, hd=64, dtype=torch.bfloat16, decay="one")),
    ("w_zero_ragged", dict(B=2, S=1000, H=4, hd=32, dtype=torch.bfloat16, state=True,
                           decay="zero")),
    # decode: one token with a carried state, at rwkv6-1.6b's heads
    ("decode", WKV6_DECODE),
    ("f32_decode", dict(WKV6_DECODE, dtype=torch.float32)),
]
_COMMON = ["--seq-len", "1024", "--batch-per-gpu", "2", "--devices", "2", "--repeats", "3",
           "--step-iters", "3"]
#: the two slowest measurements take 2 timed steps a policy
_SLOWEST = [*_COMMON[:-1], "2"]
#: The main paths, each run with the kernel counters set to 0 just before:
#: arch -> (CLI arguments, the kernels its run must launch).  Every path
#: but recurrentgemma-2b's and gemma3-1b's (one whole unit each) runs at one
#: layer (segments at 1 and 2), and the two slowest at 2 timed steps, so
#: that the whole script stays within its 1200 s: gloo's step times move by
#: up to 2.2x between runs; on an NVIDIA H100 80GB HBM3 one run took 636.5 s
#: with internlm2-20b and qwen2-moe-a2.7b at two layers, one 708.2 s with
#: qwen1.5-4b and rwkv6-1.6b at two, one 605.1 s with every path at one unit
#: and 3 timed steps, and with later phases added one 921.2 s.
MAIN_PATHS = {
    "qwen1.5-4b": (["--arch", "qwen1.5-4b", "--num-layers", "1", *_COMMON],
                   ("flash_fwd", "flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkdv")),
    "recurrentgemma-2b": (["--arch", "recurrentgemma-2b", "--num-layers", "3", *_COMMON],
                          ("flash_fwd", "flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkdv",
                           "rglru_fwd", "rglru_bwd")),
    "rwkv6-1.6b": (["--arch", "rwkv6-1.6b", "--num-layers", "1", *_COMMON],
                   ("wkv6_fwd", "wkv6_bwd")),
    "gemma3-1b": (["--arch", "gemma3-1b", "--num-layers", "6", *_COMMON],
                  ("flash_fwd", "flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkdv")),
    "internlm2-20b": (["--arch", "internlm2-20b", "--num-layers", "1", *_SLOWEST],
                      ("flash_fwd", "flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkdv")),
    "qwen2-moe-a2.7b": (["--arch", "qwen2-moe-a2.7b", "--num-layers", "1", *_SLOWEST],
                        ("flash_fwd", "flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkdv")),
}
#: kernel module -> the TPU kernel its kernels replace (file:line)
REPLACES = {"flash_attention": "src/repro/kernels/flash_attention.py:35",
            "rglru": "src/repro/kernels/rglru.py:30",
            "wkv6": "src/repro/kernels/wkv6.py:40"}


def phase(name):
    """Prints the phase's name and seconds; on a failure, ``FAILED`` and the
    traceback on stdout (kept with the rest of the run's output), then
    re-raises, so the exit code stays non-zero."""
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            print(f"== {name}", flush=True)
            try:
                out = fn(*a, **kw)
            except BaseException:
                print(f"== {name}: FAILED after {time.perf_counter() - t0:.1f} s", flush=True)
                traceback.print_exc(file=sys.stdout)
                sys.stdout.flush()
                raise
            print(f"== {name}: {time.perf_counter() - t0:.1f} s", flush=True)
            return out
        return run
    return wrap


def close(got: torch.Tensor, want: torch.Tensor, rtol: float,
          atol_rms: float) -> tuple[float, float, float, float]:
    """(max abs error, rms(want), the least atol_rms that would pass with
    this rtol, the worst entry's error over its limit rtol * |want| +
    atol_rms * rms(want))."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rms = float(w.square().mean().sqrt())
    limit = (rtol * w.abs() + atol_rms * rms).clamp_min(1e-30)
    need = float((err - rtol * w.abs()).clamp_min(0).max()) / max(rms, 1e-30)
    return float(err.max()), rms, need, float((err / limit).max())


def report(label: str, name: str, got, want, rtol: float, atol: float) -> bool:
    """Print one comparison; True when every entry is finite and within
    its limit."""
    err, rms, need, ratio = close(got, want, rtol, atol)
    ok = bool(torch.isfinite(got).all()) and ratio <= 1.0
    print(f"  {label:15s} {name:15s} {str(got.dtype)[6:]:8s} max_abs_err "
          f"{err:.3e} rms {rms:.3e} atol needed {need:.2e} rms; "
          f"{ratio:.3f} of limit (rtol {rtol:.0e}, atol {atol:.0e} rms)"
          f"{'' if ok else '  FAIL'}", flush=True)
    return ok


# ----------------------------------------------------------------------
# 3. correctness against the plain versions
# ----------------------------------------------------------------------
@phase("kernels vs plain")
def check_kernels() -> dict:
    from repro_torch.kernels import flash_attention as fa

    worst: dict[str, float] = {}
    failed: list[str] = []
    for label, shp in CHECK_SHAPES:
        q, k, v, do = make_inputs(**shp)
        causal, window, dt = shp["causal"], shp["window"], shp["dtype"]
        # as training calls it: the output also in float32 (o32), which
        # delta reads
        o, lse, o32 = fa.fwd(q, k, v, causal, window, out_f32=True)
        torch.cuda.synchronize()
        p_o, p_lse, p_o32 = fa.plain_fwd(q, k, v, causal, window, out_f32=True)
        pairs = {"flash_fwd": [(o, p_o), (lse, p_lse), (o32, p_o32)]}
        if label not in FORWARD_ONLY:
            delta = fa.bwd_delta(o32, do)
            dq = fa.bwd_dq(q, k, v, do, lse, delta, causal, window)
            dk, dv = fa.bwd_dkdv(q, k, v, do, lse, delta, causal, window)
            torch.cuda.synchronize()
            # the backward kernels are held against the plain backward on
            # the same lse/delta, so each kernel is checked on its own inputs
            p_dq, p_dk, p_dv = fa.plain_bwd(q, k, v, do, lse, delta, causal, window)
            pairs.update({"flash_bwd_delta": [(delta, fa.plain_bwd_delta(o32, do))],
                          "flash_bwd_dq": [(dq, p_dq)],
                          "flash_bwd_dkdv": [(dk, p_dk), (dv, p_dv)]})
        if label in AUTOGRAD_SHAPES:
            pairs["autograd_vs_ref"] = list(zip(*autograd_vs_ref(q, k, v, do, causal,
                                                                 window)))
        for name, items in pairs.items():
            for got, want in items:
                # lse and delta are float32 outputs of float32 math
                rtol, atol = AUTOGRAD_BF16_LIMIT if name == "autograd_vs_ref" and \
                    dt == torch.bfloat16 else LIMITS[got.dtype]
                if not report(label, name, got, want, rtol, atol):
                    failed.append(f"{name} at {label}")
                if label == "slice" and name in fa.LAUNCHES:
                    worst[name] = max(worst.get(name, 0.0),
                                      float((got.float() - want.float()).abs().max()))
        del q, k, v, do, o, lse, pairs
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"kernels disagree with their plain versions: {failed}")
    return worst


@phase("determinism")
def check_determinism() -> None:
    """``fwd``, then ``bwd_dq`` and ``bwd_dkdv`` on its lse, twice on the
    same inputs at the main paths' shapes (and whisper-tiny's
    cross-attention): o, lse, dq, dk and dv must be
    bitwise equal (each output written by one thread, no atomics; the group
    partials are summed in a fixed order).  Likewise the wkv6 forward and
    backward at rwkv6-1.6b's shape: out, s_last, the checkpoints, dr, dk,
    dv, dw, du and ds0; and the RG-LRU forward and backward at
    recurrentgemma-2b's shape: out, h_last, states, dx, dr, di, dlam and
    dh0."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import wkv6 as wk

    failed = []
    for label, shp in (("slice", SLICE), ("l_block", L_BLOCK), ("gemma3_l", GEMMA3_L),
                       ("internlm2_g", INTERNLM2_G), ("whisper_cross", WHISPER_CROSS)):
        q, k, v, do = make_inputs(**shp, seed=2)
        w, c = shp["window"], shp["causal"]
        runs = []
        for _ in range(2):
            o, lse, o32 = fa.fwd(q, k, v, c, w, out_f32=True)
            delta = fa.bwd_delta(o32, do)
            runs.append((o, lse, o32, delta, fa.bwd_dq(q, k, v, do, lse, delta, c, w),
                         *fa.bwd_dkdv(q, k, v, do, lse, delta, c, w)))
        same = {name: torch.equal(a, b)
                for name, a, b in zip(("o", "lse", "o32", "delta", "dq", "dk", "dv"), *runs)}
        print(f"  {label:15s} bitwise equal over two runs: {same}", flush=True)
        if not all(same.values()):
            failed.append(label)
        del q, k, v, do, o, lse, delta, runs
    r, k, v, w, u, _, dout, ds_last = wkv6_inputs(**WKV6_SLICE, seed=2)
    runs = []
    for _ in range(2):
        out, s_last, ckpt = wk.fwd(r, k, v, w, u, None, save_ckpt=True)
        runs.append((out, s_last, ckpt, *wk.bwd(r, k, v, w, u, ckpt, dout, ds_last)))
    same = {name: torch.equal(a, b) for name, a, b in zip(
        ("out", "s_last", "ckpt", "dr", "dk", "dv", "dw", "du", "ds0"), *runs)}
    print(f"  {'wkv6 slice':15s} bitwise equal over two runs: {same}", flush=True)
    if not all(same.values()):
        failed.append("wkv6 slice")
    del r, k, v, w, dout, runs
    x, r, i, lam, h0, dout, dh_last = rglru_inputs(**RGLRU_SLICE, seed=2)
    runs = []
    for _ in range(2):
        out, h_last, states = rg.fwd(x, r, i, lam, h0, save_states=True)
        runs.append((out, h_last, states, *rg.bwd(x, r, i, lam, h0, states, dout, dh_last)))
    same = {name: torch.equal(a, b) for name, a, b in zip(
        ("out", "h_last", "states", "dx", "dr", "di", "dlam", "dh0"), *runs)}
    print(f"  {'rglru slice':15s} bitwise equal over two runs: {same}", flush=True)
    if not all(same.values()):
        failed.append("rglru slice")
    del x, r, i, dout, runs
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"the kernels are not deterministic at {failed}")


def _kernel_label(mangled: str) -> str:
    """flash_bwd_dq_mma_kernel<bf16,128,4,64> from a mangled name (the
    tensor-core kernels take bfloat16, the others float32)."""
    name = re.search(r"flash_(?:fwd|bwd)\w*?_kernel", mangled).group()
    dtype = "bf16" if "_mma_" in name else "f32"
    args = [dtype, *re.findall(r"Li(\d+)E", mangled)]
    return f"{name}<{','.join(args)}>"


#: the flash kernels whose build is reported (forward, dq, dk/dv; not delta)
_REPORTED = re.compile(r"flash_(?:fwd|bwd_d(?:q|kdv))")


@phase("flash build")
def report_flash_build() -> None:
    """For every flash forward and backward kernel: its ``-Xptxas -v``
    lines from the build log (registers, spills), the CUDA runtime's
    registers, dynamic shared memory and CTAs per SM of each bfloat16
    tensor-core instantiation, and the HMMA instructions in its SASS
    (``cuobjdump -sass``), and one line that sums the float32 FMA kernels'
    spills (kernel, head dim, bytes stored and loaded).  Fails if a
    tensor-core kernel spills or has no HMMA; an FMA kernel's spill is
    reported, not failed."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.build import library_path

    lib = library_path(fa.SOURCE)
    failed, cur, info = [], None, {}
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1) if _REPORTED.search(m.group(1)) else None
        elif cur and ("spill" in line or "Used" in line):
            info.setdefault(_kernel_label(cur), []).append(line.strip())
    fma_spills = []
    for label, lines in sorted(info.items()):
        print(f"  ptxas {label}: {' | '.join(lines)}", flush=True)
        text = " ".join(lines)
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill", text)]
        if "_mma_" in label and any(spills):
            failed.append(f"{label} spills")
        elif any(spills):
            name, args = label[:-1].split("<")
            stores, loads = (sum(int(n) for n in re.findall(rf"(\d+) bytes spill {kind}", text))
                             for kind in ("stores", "loads"))
            fma_spills.append(f"{name} hd {args.split(',')[1]}: {stores} B stores, "
                              f"{loads} B loads")
    print(f"  FMA (float32) kernels' spills: {'; '.join(fma_spills) or 'none'}", flush=True)
    for kernel in fa.MMA_KERNELS:
        for hd in fa.SUPPORTED_HEAD_DIMS:
            print(f"  runtime {kernel} bf16 hd {hd}: {fa.occupancy(kernel, hd)}", flush=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("  cuobjdump not found: HMMA not counted", flush=True)
    else:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              check=True).stdout
        counts, cur = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\w+)", line)
            if m:
                cur = _kernel_label(m.group(1)) if _REPORTED.search(m.group(1)) else None
                if cur:
                    counts[cur] = 0
            elif cur and "HMMA" in line:
                counts[cur] += 1
        for label, n in sorted(counts.items()):
            print(f"  sass {label}: {n} HMMA", flush=True)
            if "_mma_" in label and n == 0:
                failed.append(f"{label} has no HMMA")
        failed += [f"{kernel}_mma_kernel at hd {hd} not in the SASS"
                   for kernel in fa.MMA_KERNELS for hd in fa.SUPPORTED_HEAD_DIMS
                   if not any(label.startswith(f"{kernel}_mma_kernel<bf16,{hd},")
                              for label in counts)]
    if failed:
        raise SystemExit(f"flash build: {failed}")


def report_scan_build(mod, runtime: dict) -> None:
    """For every kernel of a scan module (``rglru`` or ``wkv6``): its
    ``-Xptxas -v`` lines from the build log (registers, spills), then
    ``runtime`` (label -> the CUDA runtime's registers, shared memory,
    threads and CTAs per SM of a bfloat16 instantiation).  Fails on a
    spill."""
    from repro_torch.kernels.build import library_path

    prefix = mod.__name__.rsplit(".", 1)[1]
    failed, cur, info = [], None, {}
    for line in library_path(mod.SOURCE).with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1) if prefix in m.group(1) else None
        elif cur and ("spill" in line or "Used" in line):
            info.setdefault(cur, []).append(line.strip())
    for name, lines in sorted(info.items()):
        dtype = re.search(r"_kernelI(f|13__nv_bfloat16)", name)
        args = ([] if dtype is None else ["f32" if dtype.group(1) == "f" else "bf16"]) \
            + re.findall(r"L[ib](\d+)E", name)
        kernel = re.search(rf"\d({prefix}_[a-z0-9_]+_kernel)I", name).group(1)
        print(f"  ptxas {kernel}<{','.join(args)}>: {' | '.join(lines)}", flush=True)
        if any(int(n) for n in re.findall(r"(\d+) bytes spill", " ".join(lines))):
            failed.append(f"{name} spills")
    for label, occ in runtime.items():
        print(f"  runtime {label}: {occ}", flush=True)
    if not info:
        failed.append(f"no {prefix} kernel in the build log")
    if failed:
        raise SystemExit(f"{prefix} build: {failed}")


@phase("rglru build")
def report_rglru_build() -> None:
    """Every RG-LRU kernel's ptxas lines, and the resources of the bfloat16
    instantiations the main path runs (``rg.occupancy``)."""
    from repro_torch.kernels import rglru as rg

    report_scan_build(rg, {f"rglru {k} bf16": rg.occupancy(k) for k in rg.KERNELS})


@phase("wkv6 build")
def report_wkv6_build() -> None:
    """Every wkv6 kernel's ptxas lines, and the resources of its bfloat16
    instantiations at hd 32 and 64 (``wk.occupancy``)."""
    from repro_torch.kernels import wkv6 as wk

    report_scan_build(wk, {f"wkv6 {k} bf16 hd {hd}": wk.occupancy(k, hd)
                           for k in wk.KERNELS for hd in wk.HEAD_DIMS})


def autograd_vs_ref(q, k, v, do, causal, window):
    """(output, dq, dk, dv) through the kernels' autograd.Function and
    through autograd of the plain ``ref.attention`` (the independent oracle
    of the CPU tests) in float32 on the same values."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    got, want = [], []
    for fn, out, ins in ((fa.flash_attention, got, (q, k, v, do)),
                         (ref.attention, want, [t.float() for t in (q, k, v, do)])):
        leaves = [t.detach().requires_grad_() for t in ins[:3]]
        o = fn(*leaves, causal=causal, window=window)
        out.extend([o.detach(), *torch.autograd.grad(o, leaves, ins[3])])
    return got, want


@phase("rglru kernels vs plain")
def check_rglru() -> dict:
    """``rglru_fwd`` (out, h_last, the f32 states) against the plain
    forward, and ``rglru_bwd`` (dx, dr, di, dlam, dh0) against autograd
    through ``ref.rglru`` on the same inputs, element by element with
    ``LIMITS`` by each output's dtype (the scan is float32 math on both
    sides; bf16 outputs round once)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru as rg

    worst: dict[str, float] = {}
    failed: list[str] = []
    for label, shp in RGLRU_SHAPES:
        x, r, i, lam, h0, dout, dh_last = rglru_inputs(**shp)
        out, h_last, states = rg.fwd(x, r, i, lam, h0, save_states=True)
        got_bwd = rg.bwd(x, r, i, lam, h0, states, dout, dh_last)
        torch.cuda.synchronize()
        p_out, p_h, p_states = rg.plain_fwd(x, r, i, lam, h0, save_states=True)
        leaves = [t.detach().requires_grad_() for t in (x, r, i, lam)]
        if h0 is not None:
            leaves.append(h0.detach().requires_grad_())
        o, h = ref.rglru(*leaves[:4], leaves[4] if h0 is not None else None)
        want_bwd = torch.autograd.grad((o, h), leaves, (dout, dh_last))
        pairs = {"rglru_fwd": [(out, p_out), (h_last, p_h), (states, p_states)],
                 "rglru_bwd": list(zip(got_bwd, want_bwd))}
        for name, items in pairs.items():
            for got, want in items:
                if not report(label, name, got, want, *LIMITS[got.dtype]):
                    failed.append(f"{name} at {label}")
                if label == "slice":
                    worst[name] = max(worst.get(name, 0.0),
                                      float((got.float() - want.float()).abs().max()))
        del x, r, i, dout, out, states, got_bwd, p_out, p_states, leaves, o, want_bwd, pairs
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"RG-LRU kernels disagree with their plain versions: {failed}")
    return worst


@phase("wkv6 kernels vs plain")
def check_wkv6() -> dict:
    """``wkv6_fwd`` (out, s_last, the f32 checkpoints) against the plain
    forward, and ``wkv6_bwd`` (dr, dk, dv, dw, du, ds0) against autograd
    through ``ref.wkv6`` on the same inputs, element by element with
    ``LIMITS`` by each output's dtype (float32 math on both sides; bf16
    outputs round once)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wk

    worst: dict[str, float] = {}
    failed: list[str] = []
    for label, shp in WKV6_SHAPES:
        r, k, v, w, u, st, dout, ds_last = wkv6_inputs(**shp)
        out, s_last, ckpt = wk.fwd(r, k, v, w, u, st, save_ckpt=True)
        got_bwd = wk.bwd(r, k, v, w, u, ckpt, dout, ds_last)
        torch.cuda.synchronize()
        p_out, p_s, p_ckpt = wk.plain_fwd(r, k, v, w, u, st, save_ckpt=True)
        leaves = [t.detach().requires_grad_() for t in (r, k, v, w, u)]
        if st is not None:
            leaves.append(st.detach().requires_grad_())
        o, s = ref.wkv6(*leaves[:5], state=leaves[5] if st is not None else None)
        want_bwd = torch.autograd.grad((o, s), leaves, (dout, ds_last))
        del o, s
        pairs = {"wkv6_fwd": [(out, p_out), (s_last, p_s), (ckpt, p_ckpt)],
                 "wkv6_bwd": list(zip(got_bwd, want_bwd))}
        for name, items in pairs.items():
            for got, want in items:
                if not report(label, name, got, want, *LIMITS[got.dtype]):
                    failed.append(f"{name} at {label}")
                if label == "slice":
                    worst[name] = max(worst.get(name, 0.0),
                                      float((got.float() - want.float()).abs().max()))
        del r, k, v, w, dout, out, ckpt, got_bwd, p_out, p_ckpt, leaves, want_bwd, pairs
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"wkv6 kernels disagree with their plain versions: {failed}")
    return worst


#: reduced models of the model check: arch -> (depth, kernel -> launches
#: per unit in one forward, overrides of ``reduced()``: the MoE archs take
#: 8 experts, so that top-k selects)
MODEL_CHECKS = {"qwen1.5-4b": (2, {"flash_fwd": 1}, {}),
                "recurrentgemma-2b": (3, {"flash_fwd": 1, "rglru_fwd": 2}, {}),
                "rwkv6-1.6b": (2, {"wkv6_fwd": 1}, {}),
                "gemma3-1b": (2, {"flash_fwd": 2}, {}),
                "qwen2-moe-a2.7b": (2, {"flash_fwd": 1}, {"num_experts": 8}),
                "grok-1-314b": (2, {"flash_fwd": 1}, {"num_experts": 8}),
                "internlm2-20b": (2, {"flash_fwd": 1}, {}),
                # C blocks (self and cross), plus whisper's encoder layers
                "whisper-tiny": (2, {"flash_fwd": 2}, {}),
                "llama-3.2-vision-90b": (2, {"flash_fwd": 3}, {})}


#: CPU threads of the model check's CPU side, so that its sums run in one
#: order from run to run
MODEL_CHECK_THREADS = 4


def worst_leaf(paths: list[str], want: list, got: list) -> tuple[float, str]:
    """(the largest error of a gradient leaf over its scale, that leaf).
    The cross-attention's key bias (``xattn/bk``: QKV bias, no RoPE) adds
    q . bk to every score of a query row, which the softmax cancels: its
    gradient is 0 in exact arithmetic, and both sides' round-off there is
    measured against the largest leaf's scale instead of its own."""
    top = max(float(a.abs().max()) for a in want)
    return max((float((b.float() - a.float()).abs().max())
                / (top if path.endswith("xattn/bk") else max(float(a.abs().max()), 1e-6)), path)
               for path, a, b in zip(paths, want, got))


@phase("model on the card vs the CPU")
def check_model() -> None:
    """Reduced qwen1.5-4b (float32, 2 layers, head dim 64), reduced
    recurrentgemma-2b (float32, RRL, rnn width 256, window 64 under 256
    tokens), reduced rwkv6-1.6b (float32, 2 W layers, 4 wkv heads of 64),
    reduced gemma3-1b (float32, LG, one kv head, window 64 under 256
    tokens), reduced qwen2-moe-a2.7b (float32, 2 G layers, 8 experts, top-4,
    shared experts; 512 tokens, 8 groups of 64), reduced grok-1-314b (the
    same with top-2, no shared experts), reduced internlm2-20b (float32,
    2 G layers), reduced whisper-tiny (2 C layers, 2 encoder layers over 64
    frames: bidirectional and cross-attention) and reduced
    llama-3.2-vision-90b (GC, 16 image tokens): loss and every gradient
    leaf (the encoder's too) through the kernels on the card
    against the plain versions on the CPU (``MODEL_CHECK_THREADS``
    threads), from the same parameters and batch.  Tolerance 1e-4 of each
    leaf's scale: both sides are float32 (TF32 off), summed in different
    orders.  The card side runs twice and must give bitwise-equal loss
    and leaves; the worst leaf of each arch is printed."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import init_params, model_loss
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    threads = torch.get_num_threads()
    torch.set_num_threads(MODEL_CHECK_THREADS)
    failed = []
    for arch, (depth, per_unit, over) in MODEL_CHECKS.items():
        cfg = get_config(arch).reduced(num_layers=depth, **over)
        g = torch.Generator().manual_seed(0)
        tokens, labels = (torch.randint(0, cfg.vocab_size, (2, 256), generator=g)
                          for _ in range(2))
        n_enc = cfg.encoder_seq or cfg.num_image_tokens
        enc = torch.randn(2, n_enc, cfg.d_model, generator=g) if n_enc else None
        params = init_params(cfg, seed=0)
        results = []
        for dev in ("cpu", "cuda", "cuda"):
            p = T.map_leaves(lambda _, t: t.to(dev).requires_grad_(), params)
            leaves = [t for _, t in T.leaf_order(p)]
            before = kernels.all_launches()
            loss = model_loss(cfg, p, tokens.to(dev), labels.to(dev),
                              encoder_in=None if enc is None else enc.to(dev))[0]
            launched = {k: n - before[k] for k, n in kernels.all_launches().items()}
            grads = torch.autograd.grad(loss, leaves)
            results.append((float(loss.detach()), [gr.cpu() for gr in grads]))
            want = {k: n * cfg.num_units + cfg.encoder_layers * (k == "flash_fwd")
                    for k, n in per_unit.items()}
            if dev == "cuda" and any(launched[k] != n for k, n in want.items()):
                raise SystemExit(f"{arch} on the card: forward launches {launched}, "
                                 f"want {want}")
        (l_cpu, g_cpu), (l_gpu, g_gpu), (l_gpu2, g_gpu2) = results
        paths = ["/".join(map(str, path)) for path, _ in T.leaf_order(params)]
        worst, leaf = worst_leaf(paths, g_cpu, g_gpu)
        varied = [path for path, a, b in zip(paths, g_gpu, g_gpu2) if not torch.equal(a, b)]
        print(f"  {arch}: loss cpu {l_cpu:.6f} card {l_gpu:.6f}; worst gradient leaf "
              f"{leaf} error {worst:.3e} of its scale (tol 1e-4); card twice: loss "
              f"{'equal' if l_gpu == l_gpu2 else f'{l_gpu2:.9g} vs {l_gpu:.9g}'}, "
              f"{len(paths) - len(varied)} of {len(paths)} leaves bitwise equal"
              f"{'' if not varied else f' (differ: {varied})'}", flush=True)
        if not (math.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)) \
                or worst > 1e-4:
            failed.append(arch)
        if varied or l_gpu != l_gpu2:
            failed.append(f"{arch} (card runs differ)")
    torch.set_num_threads(threads)
    if failed:
        raise SystemExit(f"model on the card disagrees with the CPU or with itself: {failed}")


# ----------------------------------------------------------------------
# 4. timing at the slice shape
# ----------------------------------------------------------------------
def library_times(q, k, v, o, do, window, causal=True) -> dict:
    """scaled_dot_product_attention forward, its backward (one call giving
    dq, dk, dv), and ``torch.linalg.vecdot`` for delta (rowsum(dO * O),
    (B, S, H) in bf16 where the kernel writes (B, H, S) in f32; on the
    bf16 output, since vecdot takes one dtype and the kernel reads o32),
    on the same inputs; (B, H, S, hd) views for SDPA, with k and v expanded to the
    H query heads beforehand where K < H (the library's flash kernels take
    equal head counts).  Where the window is shorter than the sequence,
    :func:`windowed_library_times` times the same windowed function;
    bidirectional or cross-attention (``Sq != Skv``),
    :func:`unmasked_library_times`."""
    import torch.nn.functional as F

    from repro_torch.kernels.ref import repeat_kv

    if not causal:
        return {"flash_bwd_delta": time_ms(lambda: torch.linalg.vecdot(o, do, dim=-1)),
                **unmasked_library_times(q, k, v, o, do)}
    H, K = q.shape[2], k.shape[2]
    k, v = repeat_kv(k, H // K).contiguous(), repeat_kv(v, H // K).contiguous()
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    out = {"flash_bwd_delta": time_ms(lambda: torch.linalg.vecdot(o, do, dim=-1))}
    if window is not None and window < q.shape[1]:
        return {**out, **windowed_library_times(qt, kt, vt, dot, window, o)}
    out["flash_fwd"] = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                      is_causal=True))
    try:
        o, lse, cq, ck, mq, mk, seed, off, _ = \
            torch.ops.aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, True)
        bwd = lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(  # noqa: E731
            dot, qt, kt, vt, o, lse, cq, ck, mq, mk, 0.0, True, seed, off)
        out["flash_bwd_dq"] = out["flash_bwd_dkdv"] = time_ms(bwd)
    except (RuntimeError, TypeError) as e:   # library op missing or refusing
        print(f"  library backward not timed: {e}", flush=True)
    return out


def unmasked_library_times(q, k, v, o, do) -> dict:
    """SDPA forward of the unmasked function (``is_causal=False``, kv of
    its own length, ``enable_gqa`` over the kernels' (B, Skv, K, hd) k and
    v: no expansion), and its backward (the autograd node: dq, dk, dv in one
    call); the output held to the kernel's within ``LIBRARY_LIMIT`` and
    the backend PyTorch chose named from one profiled call.  Nothing where
    SDPA refuses, with its reason."""
    import torch.nn.functional as F

    leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    fwd = lambda: F.scaled_dot_product_attention(*leaves, is_causal=False,  # noqa: E731
                                                 enable_gqa=True)
    try:
        out = fwd()
    except (RuntimeError, TypeError) as e:   # no backend takes it
        print(f"  library: SDPA refuses (is_causal=False, enable_gqa): "
              f"{str(e).splitlines()[0][:160]}", flush=True)
        return {}
    ratio = close(out.detach().transpose(1, 2), o, *LIBRARY_LIMIT)[3]
    kernels = [name for name in device_times(fwd) if "elementwise" not in name]
    print(f"  library: SDPA (is_causal=False, enable_gqa), output {ratio:.3f} of the limit "
          f"from the kernel's; its kernels {[n[:60] for n in kernels[:3]]}", flush=True)
    if ratio > 1.0:
        return {}
    res = {"flash_fwd": time_ms(fwd)}
    if q.shape[1] > 1:
        dot = do.transpose(1, 2)
        bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True))
        res.update({"flash_bwd_dq": bwd_ms, "flash_bwd_dkdv": bwd_ms})
    return res


def windowed_library_times(qt, kt, vt, dot, window, o) -> dict:
    """SDPA forward and backward of the sliding-window function the kernels
    compute (query i sees keys i - window < j <= i), through a boolean band
    mask: the first SDPA backend that takes the mask (cuDNN, then memory
    efficient, then math) and whose output agrees with the kernel's ``o``
    within ``LIBRARY_LIMIT`` is named and timed, beside the reasons the
    backends before it gave; the backward is the autograd node of that
    forward (dq, dk, dv in one call).  Nothing when no backend takes it,
    with the reasons printed."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    S = qt.shape[2]
    pos = torch.arange(S, device=qt.device)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    refused = []
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                fwd = lambda: F.scaled_dot_product_attention(*leaves, attn_mask=band)  # noqa: E731
                out = fwd()
                fwd_ms = time_ms(fwd)
        except RuntimeError as e:            # the backend refuses the mask or shape
            refused.append(f"{backend.name}: {str(e).splitlines()[0][:120]}")
            continue
        ratio = close(out.detach().transpose(1, 2), o, *LIBRARY_LIMIT)[3]
        if ratio > 1.0:
            refused.append(f"{backend.name}: output {ratio:.3f} of the limit from the kernel's")
            continue
        bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True))
        print(f"  library: windowed SDPA (boolean band mask, window {window}) on "
              f"{backend.name}, output {ratio:.3f} of the limit from the kernel's; "
              f"refused: {refused or 'none'}", flush=True)
        return {"flash_fwd": fwd_ms, "flash_bwd_dq": bwd_ms, "flash_bwd_dkdv": bwd_ms}
    print(f"  library: no SDPA backend takes the window-{window} band mask, so no library "
          f"time (refused: {refused})", flush=True)
    return {}


def print_row(label: str, name: str, row: dict) -> None:
    print(f"  {label:8s} {name:16s} " + " ".join(
        f"{key} {val:.4f}" if isinstance(val, float) else f"{key} {val}"
        for key, val in row.items()), flush=True)


def time_flash(shp: dict, label: str, forward_only: bool = False) -> dict:
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = make_inputs(**shp, seed=1)
    w, c, train = shp["window"], shp["causal"], not forward_only
    # each call as its path makes it: in training the forward also writes
    # o32 and delta reads it
    o, lse, o32 = fa.fwd(q, k, v, c, w, out_f32=True)
    delta = fa.bwd_delta(o32, do)
    runs = {
        "flash_fwd": (lambda: fa.fwd(q, k, v, c, w, out_f32=train),
                      lambda: fa.plain_fwd(q, k, v, c, w, out_f32=train)),
        "flash_bwd_delta": (lambda: fa.bwd_delta(o32, do),
                            lambda: fa.plain_bwd_delta(o32, do)),
        "flash_bwd_dq": (lambda: fa.bwd_dq(q, k, v, do, lse, delta, c, w),
                         lambda: fa.plain_bwd(q, k, v, do, lse, delta, c, w)),
        "flash_bwd_dkdv": (lambda: fa.bwd_dkdv(q, k, v, do, lse, delta, c, w),
                           lambda: fa.plain_bwd(q, k, v, do, lse, delta, c, w)),
    }
    if forward_only:
        runs = {"flash_fwd": runs["flash_fwd"]}
    bnd = bounds(**shp, train=train)
    lib = library_times(q, k, v, o, do, w, c)
    out = {}
    for name, (kern, plain) in runs.items():
        out[name] = {"ms": time_ms(kern), "plain_ms": time_ms(plain, iters=5),
                     "bound_ms": bnd[name][0], "bound_by": bnd[name][1],
                     "library_ms": lib.get(name)}
        print_row(label, name, out[name])
    if forward_only:
        return out
    pair = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkdv"]["ms"]
    lib_bwd = out["flash_bwd_dq"]["library_ms"]
    print(f"  {label:8s} backward pair (dq + dk/dv) {pair:.4f} ms; library backward "
          f"{'not timed' if lib_bwd is None else f'{lib_bwd:.4f} ms'}", flush=True)
    del q, k, v, do, o, lse, o32, delta, runs
    torch.cuda.empty_cache()
    return out


def time_rglru(shp: dict, label: str) -> dict:
    """No single PyTorch call computes a gated linear recurrence, so there
    is no library time."""
    from repro_torch.kernels import rglru as rg

    x, r, i, lam, _, dout, dh_last = rglru_inputs(**shp, seed=1)
    _, _, states = rg.fwd(x, r, i, lam, None, save_states=True)
    dh_last = torch.zeros_like(dh_last)
    runs = {
        "rglru_fwd": (lambda: rg.fwd(x, r, i, lam, None, save_states=True),
                      lambda: rg.plain_fwd(x, r, i, lam, None, save_states=True)),
        "rglru_bwd": (lambda: rg.bwd(x, r, i, lam, None, states, dout, dh_last),
                      lambda: rg.plain_bwd(x, r, i, lam, None, states, dout, dh_last)),
    }
    bnd = rglru_bounds(**shp)
    out = {}
    for name, (kern, plain) in runs.items():
        out[name] = {"ms": time_ms(kern), "plain_ms": time_ms(plain, iters=3),
                     "bound_ms": bnd[name][0], "bound_by": bnd[name][1], "library_ms": None}
        print_row(label, name, out[name])
        print_profile(f"{label} {name}'s CUDA kernels (L2 warm)", device_times(kern))
    return out


def time_wkv6(shp: dict, label: str) -> dict:
    """No single PyTorch call computes the wkv scan, so there is no library
    time."""
    from repro_torch.kernels import wkv6 as wk

    r, k, v, w, u, _, dout, ds_last = wkv6_inputs(**shp, seed=1)
    _, _, ckpt = wk.fwd(r, k, v, w, u, None, save_ckpt=True)
    ds_last = torch.zeros_like(ds_last)
    runs = {
        "wkv6_fwd": (lambda: wk.fwd(r, k, v, w, u, None, save_ckpt=True),
                     lambda: wk.plain_fwd(r, k, v, w, u, None, save_ckpt=True)),
        "wkv6_bwd": (lambda: wk.bwd(r, k, v, w, u, ckpt, dout, ds_last),
                     lambda: wk.plain_bwd(r, k, v, w, u, ckpt, dout, ds_last)),
    }
    bnd = wkv6_bounds(**shp)
    out = {}
    for name, (kern, plain) in runs.items():
        out[name] = {"ms": time_ms(kern), "plain_ms": time_ms(plain, iters=3),
                     "bound_ms": bnd[name][0], "bound_by": bnd[name][1], "library_ms": None}
        print_row(label, name, out[name])
        print_profile(f"{label} {name}'s CUDA kernels (L2 warm)", device_times(kern))
    return out


@phase("device profile of one unit")
def profile_units() -> None:
    """One unit's forward, then its backward, on each main path at the
    published widths (batch 2 x 1024 tokens, bfloat16, one rank, random
    parameters from seed 0; a unit is one layer pattern: qwen1.5-4b ``G``,
    recurrentgemma-2b ``RRL``, rwkv6-1.6b ``W``, gemma3-1b ``LLLLLG``,
    internlm2-20b ``G``, qwen2-moe-a2.7b ``G`` with the MoE MLP, whose
    router, dispatch, expert and combine einsums are device work of their
    own): device time per kernel name from ``torch.profiler``, and the wall
    time of the same call (CUDA events, L2 warm), so that the two can be
    set side by side."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks as Bk
    from repro_torch.models import transformer as T

    for arch in MAIN_PATHS:
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(0)
        unit = {f"b{i}": Bk.init_block(cfg, kind, gen, "cuda")
                for i, kind in enumerate(cfg.layer_pattern)}
        leaves = [t.requires_grad_() for _, t in T.leaf_order(unit)]
        x = torch.randn(2, 1024, cfg.d_model, generator=gen, device="cuda").to(cfg.dtype)
        x.requires_grad_()
        dy = torch.randn(x.shape, generator=gen, device="cuda").to(cfg.dtype)

        def fwd():
            y = x
            for i, kind in enumerate(cfg.layer_pattern):
                y = Bk.apply_block(cfg, kind, unit[f"b{i}"], y)[0]
            return y

        def bwd(y):
            return torch.autograd.grad(y, [x, *leaves], dy, retain_graph=True)

        with torch.no_grad():
            print_profile(f"{arch} unit forward ({cfg.layer_pattern}), "
                          f"{time_ms(fwd, iters=5):.4f} ms a call", device_times(fwd))
        y = fwd()
        print_profile(f"{arch} unit backward, {time_ms(lambda: bwd(y), iters=5):.4f} ms a call",
                      device_times(lambda: bwd(y)))
        del unit, leaves, x, dy, y
        torch.cuda.empty_cache()


@phase("timing")
def time_kernels() -> dict:
    """Each kernel at its main path's shape (the kernels line); the flash
    kernels also at recurrentgemma-2b's local-attention shape, at
    gemma3-1b's L and G shapes, at the G shapes of internlm2-20b,
    qwen1.5-32b and qwen2-moe-a2.7b, and at the encoder-decoder path's six
    (printed rows of their own; ``cross_decode`` forward only)."""
    timing = {**time_flash(SLICE, "slice"), **time_rglru(RGLRU_SLICE, "slice"),
              **time_wkv6(WKV6_SLICE, "slice")}
    time_flash(L_BLOCK, "l_block")
    time_flash(GEMMA3_L, "gemma3_l")
    time_flash(GEMMA3_G, "gemma3_g")
    time_flash(INTERNLM2_G, "internlm2_g")
    time_flash(QWEN32_G, "qwen32_g")
    time_flash(QWEN2MOE_G, "qwen2moe_g")
    for label, shp in (("whisper_enc", WHISPER_ENC), ("whisper_dec", WHISPER_DEC),
                       ("whisper_cross", WHISPER_CROSS), ("llama_g", LLAMA_G),
                       ("llama_cross", LLAMA_CROSS), ("cross_decode", CROSS_DECODE)):
        time_flash(shp, label, forward_only=label in FORWARD_ONLY)
    return timing


# ----------------------------------------------------------------------
# 5-6. the main path: the measurement loop through the kernels
# ----------------------------------------------------------------------
def run_measure(arch: str, args: list[str], trace_dir: Path) -> tuple[dict, dict]:
    """(the measured JSON, the DAG model's error per policy on it): the
    written trace goes through ``repro_torch.measure.model_vs_measured``
    and is copied into ``trace_dir`` (for the sweep phase) before its
    temporary directory goes."""
    from repro_torch import kernels
    from repro_torch.measure.model_vs_measured import model_error
    from repro_torch.measure.run import main as measure_main

    @phase(f"measure {arch}")
    def run() -> tuple[dict, dict]:
        with tempfile.TemporaryDirectory() as tmp:
            kernels.reset_launches()
            rc = measure_main(args + ["--out-dir", tmp])
            if rc != 0:
                raise SystemExit(f"repro_torch.measure exited {rc}")
            doc = json.loads((Path(tmp) / f"{arch}.json").read_text())
            trace_text = (Path(tmp) / f"{arch}.trace").read_text()
            errors = model_error(doc, Path(tmp) / f"{arch}.trace")
            shutil.copy(Path(tmp) / f"{arch}.trace", trace_dir / f"{arch}.trace")
        check_measurement(doc, trace_text)
        return doc, errors

    return run()


@phase("model vs measured (Fig. 4)")
def report_model_vs_measured(results: dict) -> None:
    """For each main path (arch -> (measured JSON, errors)): the alpha-beta
    fit and ``t_u`` the prediction used, then per sync policy the measured
    and the predicted seconds per iteration and |predicted - measured| /
    measured.  Fails if a prediction is not finite and positive or the
    predicted policies are not the measured ones; sets no error ceiling."""
    failed = []
    for arch, (doc, errors) in results.items():
        fit = doc["allreduce_fit"]
        print(f"  {arch:18s} fit latency {fit['latency_s']:.6g} s, bandwidth "
              f"{fit['bandwidth_bytes_per_s'] / 1e9:.6g} GB/s; t_u {doc['t_update_s']:.6g} s",
              flush=True)
        for pol, row in errors.items():
            print(f"  {arch:18s} {pol:9s} measured {row['measured_s']:.6g} s/it  predicted "
                  f"{row['predicted_s']:.6g} s/it  error {row['error_pct']:.2f} %", flush=True)
            if not (math.isfinite(row["predicted_s"]) and row["predicted_s"] > 0):
                failed.append(f"{arch} {pol}: predicted {row['predicted_s']}")
        if set(errors) != set(doc["policy_times_s"]):
            failed.append(f"{arch}: predicted {sorted(errors)}, measured "
                          f"{sorted(doc['policy_times_s'])}")
    if failed:
        raise SystemExit(f"model vs measured: {failed}")


# ----------------------------------------------------------------------
# 9. the DAG model's sweep on the card
# ----------------------------------------------------------------------
#: The sweep backend against the port's NumPy engine: the reference suite's
#: tolerance for its accelerator backend (tests/test_batched_jax.py).
SWEEP_RTOL, SWEEP_ATOL = 1e-6, 1e-12
#: Gradients on the card against the CPU, and against central differences.
GRAD_CPU_RTOL, GRAD_FD_RTOL = 1e-9, 1e-3


def _median_s(fn, reps: int = 20) -> float:
    """Median host seconds of ``fn`` (which must end synchronised) over
    ``reps`` calls after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def _cuda_kernels(fn) -> tuple[int, float]:
    """(CUDA kernels launched, their device ms) over one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(dev), sum(e.device_time_total for e in dev) / 1e3


def _kernel_census(fn, calls: int = 3) -> list[tuple[int, int, dict]]:
    """For each of ``calls`` profiled calls of ``fn``: (CUDA kernels, aten
    operators dispatched on the host, kernels by name)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    out = []
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = Counter(e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        ops = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU
                  and e.name.startswith("aten::"))
        out.append((sum(dev.values()), ops, dict(dev)))
    return out


def sweep_grid_on_card(label: str, grid, device: str = "cuda") -> dict:
    """One grid through the sweep backend on the card: checked against the
    port's NumPy engine column by column, then timed.  Returns the
    numbers printed."""
    from repro_torch.core import batched_torch as BT
    from repro_torch.core.batched import grid_evaluator
    from repro_torch.core.sweep import sweep

    n = len(grid)
    t0 = time.perf_counter()
    tev = BT.torch_grid_evaluator(grid, device=device)
    build_s = time.perf_counter() - t0
    on_card = tev.device_columns()
    off = {k: str(v.device) for k, v in on_card.items()
           if v.device.type != device or v.dtype != torch.float64}
    if off:
        raise SystemExit(f"sweep {label}: result columns not float64 on {device}: {off}")
    got = {k: v.cpu().numpy() for k, v in on_card.items()}
    ev = grid_evaluator(grid)

    def numpy_tiers() -> dict:
        # the NumPy engine's two tiers over the whole grid (and its tail
        # columns and method labels, which on these deterministic grids
        # are a copy of iteration_time_s and one gather)
        return ev.run().columns_slice(0, n)

    want = numpy_tiers()
    worst = 0.0
    for k, g in got.items():
        w = want[k]
        excess = np.abs(g - w) - (SWEEP_RTOL * np.abs(w) + SWEEP_ATOL)
        rel = float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-300)))
        worst = max(worst, rel)
        if g.shape != (n,) or not np.isfinite(g).all() or (excess > 0).any():
            raise SystemExit(f"sweep {label}: column {k} off the NumPy engine "
                             f"(worst relative {rel:.3e})")
    ours = sweep(grid, device=device)
    theirs = sweep(grid, backend="numpy")
    for k in ours.columns:
        a, b = ours.columns[k], theirs.columns[k]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=SWEEP_RTOL, atol=SWEEP_ATOL, err_msg=k)
        elif a.tolist() != b.tolist():
            raise SystemExit(f"sweep {label}: labels of {k} differ from the NumPy engine")
    if ours.n_simulated or (ours.n_analytical, ours.n_timeline) != \
            (theirs.n_analytical, theirs.n_timeline):
        raise SystemExit(f"sweep {label}: row accounting {ours.meta()}")

    def tiers_on_card():
        tev.device_columns()
        torch.cuda.synchronize()

    out = {
        "scenarios": n, "kernel_points": len(ev._kwidx), "layers": ev._wax.flops.shape[1],
        "timeline_specs": len(ev._pax.tl_specs), "worst_rel": worst,
        "build_s": build_s,
        "tiers_device_s": _median_s(tiers_on_card),
        "columns_s": _median_s(tev.columns),
        "numpy_tiers_s": _median_s(numpy_tiers),
        "sweep_s": _median_s(lambda: sweep(grid, device=device)),
        "numpy_sweep_s": _median_s(lambda: sweep(grid, backend="numpy")),
    }
    out["cuda_kernels"], out["device_ms"] = _cuda_kernels(tev.device_columns)
    out["census"] = _kernel_census(tev.device_columns)
    print(f"  {label}: {n} scenarios, {out['kernel_points']} kernel points x "
          f"{out['layers']} layers, {out['timeline_specs']} timeline specs; worst "
          f"relative {worst:.3e} against NumPy (limit {SWEEP_RTOL:g}); "
          f"{ours.n_analytical} analytical, {ours.n_timeline} timeline, "
          f"{ours.n_simulated} simulated", flush=True)
    print(f"  {label}: evaluator built (structure + copy to the card) in "
          f"{build_s * 1e3:.3f} ms; one evaluation launches {out['cuda_kernels']} CUDA "
          f"kernels, {out['device_ms']:.4f} ms of device time; three more profiled "
          f"evaluations: {[c[0] for c in out['census']]} CUDA kernels, "
          f"{[c[1] for c in out['census']]} aten operators, "
          f"{[len(c[2]) for c in out['census']]} kernel names", flush=True)
    for what, s_card, s_np in (("two tiers", out["columns_s"], out["numpy_tiers_s"]),
                               ("sweep()", out["sweep_s"], out["numpy_sweep_s"])):
        print(f"  {label}: {what}: {device} {s_card * 1e3:.4f} ms ({n / s_card:,.0f} "
              f"scenarios/s), numpy {s_np * 1e3:.4f} ms ({n / s_np:,.0f} scenarios/s)",
              flush=True)
    print(f"  {label}: two tiers on the card, synchronised, no copy back: "
          f"{out['tiers_device_s'] * 1e3:.4f} ms", flush=True)
    return out


def report_kernel_census(small: list, large: list) -> None:
    """Whether one evaluation of the two grids launches different CUDA
    kernels: the kernel names whose counts differ, per profiled call, and
    every kernel name of the first call with its count."""
    for i, ((n_s, ops_s, by_s), (n_l, ops_l, by_l)) in enumerate(zip(small, large)):
        diff = {k: (by_s.get(k, 0), by_l.get(k, 0)) for k in sorted(set(by_s) | set(by_l))
                if by_s.get(k, 0) != by_l.get(k, 0)}
        print(f"  kernel census, call {i}: frontier {n_s} kernels / {ops_s} aten operators, "
              f"frontier + traces {n_l} / {ops_l}; counts that differ (frontier, + traces): "
              + ("none" if not diff else "; ".join(f"{k[:90]} {a} vs {b}"
                                                   for k, (a, b) in diff.items())),
              flush=True)
    print("  kernel names (frontier, call 0): " + "; ".join(
        f"{k[:100]} x{n}" for k, n in sorted(small[0][2].items())), flush=True)


def check_sweep_gradients(device: str = "cuda") -> None:
    """``grad_iteration_time`` on the card at the two family grids of the
    reference's gradient tests: equal to the CPU's, equal to central
    differences on the NumPy twin, finite, and exactly 0 in bucket_bytes."""
    from repro_torch.core import batched_torch as BT
    from repro_torch.core.scenarios import ScenarioGrid

    for policies in (("caffe-mpi", "mxnet", "naive"),
                     ("bucketed-4mb", "bucketed-25mb", "priority")):
        grid = ScenarioGrid(workloads=("resnet50",), clusters=("v100-nvlink-ib",),
                            worker_counts=(16,), policies=policies,
                            collectives=("ring", "hierarchical"))
        p0 = BT.default_params(grid, device="cpu")
        on_card = BT.grad_iteration_time(grid, device=device)
        on_cpu = BT.grad_iteration_time(grid, device="cpu")
        worst_fd = 0.0
        for key in BT.PARAM_KEYS:
            g = on_card[key]
            if not np.isfinite(g).all():
                raise SystemExit(f"gradient {key} not finite: {g}")
            np.testing.assert_allclose(g, on_cpu[key], rtol=GRAD_CPU_RTOL, atol=0,
                                       err_msg=key)
            fd = np.zeros_like(p0[key])
            for i in range(fd.size):
                eps = abs(float(p0[key].ravel()[i])) * 1e-5 or 1e-9
                hi = {k: v.copy() for k, v in p0.items()}
                lo = {k: v.copy() for k, v in p0.items()}
                hi[key].ravel()[i] += eps
                lo[key].ravel()[i] -= eps
                fd.ravel()[i] = (BT.numpy_iteration_times(grid, hi).sum()
                                 - BT.numpy_iteration_times(grid, lo).sum()) / (2 * eps)
            np.testing.assert_allclose(g, fd, rtol=GRAD_FD_RTOL, atol=1e-12, err_msg=key)
            nz = np.abs(fd) > 0
            if nz.any():
                worst_fd = max(worst_fd, float(np.max(np.abs(g[nz] - fd[nz]) / np.abs(fd[nz]))))
        if np.any(on_card["bucket_bytes"] != 0.0):
            raise SystemExit(f"bucket_bytes gradient {on_card['bucket_bytes']}")
        print(f"  gradients {'/'.join(policies)}: "
              + ", ".join(f"{k} {on_card[k].tolist()}" for k in BT.PARAM_KEYS)
              + f"; worst relative to central differences {worst_fd:.3e}", flush=True)


@phase("sweep on the card")
def check_sweep(trace_dir: Path, device: str = "cuda") -> None:
    """Phase 9: the sweep backend on CUDA over the frontier grid, over the
    same axes on the paper CNNs plus this run's traces, the
    measured-workloads grid, and the gradients."""
    import dataclasses

    from repro_torch.core.scenarios import ScenarioGrid, frontier_grid
    from repro_torch.core.sweep import sweep

    traces = tuple(f"torch:{trace_dir / f'{arch}.trace'}" for arch in MAIN_PATHS)
    frontier = frontier_grid()
    small = sweep_grid_on_card("frontier", frontier, device)
    large = sweep_grid_on_card("frontier + traces", dataclasses.replace(
        frontier, workloads=frontier.workloads + traces), device)
    report_kernel_census(small["census"], large["census"])
    # benchmarks/bench_model_vs_measured.py:74-80, over this run's traces
    measured = ScenarioGrid(workloads=traces, clusters=("k80-pcie-10gbe", "v100-nvlink-ib"),
                            worker_counts=(2, 8, 32),
                            policies=("cntk", "caffe-mpi", "bucketed-25mb", "priority"),
                            collectives=("ring",))
    res = sweep(measured, device=device)
    ref = sweep(measured, backend="numpy")
    print(f"  measured workloads: {res.meta()}", flush=True)
    if res.n_simulated or not res.n_timeline or \
            res.n_analytical + res.n_timeline != len(measured) or \
            (res.n_analytical, res.n_timeline) != (ref.n_analytical, ref.n_timeline):
        raise SystemExit(f"measured workloads: row accounting {res.meta()}")
    for k in ("iteration_time_s", "samples_per_sec", "speedup", "t_comm_s", "t_comp_s"):
        np.testing.assert_allclose(res.columns[k], ref.columns[k], rtol=SWEEP_RTOL,
                                   atol=SWEEP_ATOL, err_msg=k)
    check_sweep_gradients(device)


# ----------------------------------------------------------------------
# 10. the sweep service on the card
# ----------------------------------------------------------------------
SERVICE_HET, SERVICE_STRAGGLER = "het:1x0.5+3x1.0", "lognormal:0.2x16"
SERVICE_FAULT = "fail:0.05@restart2x16"
#: The oracle grid: every policy, het, sync_k and fault axis against the
#: event-driven simulator (draws of x8: each draw is one simulation).
ORACLE_WORKERS, ORACLE_FAULT = (2, 4), "fail:0.05@restart2x8"


def service_queries() -> list[dict]:
    """At least 8 torch queries: the frontier axes split by workload, the
    mixed grid, and one with het, straggler, sync_k and fault axes, under
    seeds 0 and 7."""
    from repro_torch.core.scenarios import frontier_grid

    out = []
    for seed in (0, 7):
        out += [{"grid": "frontier", "workloads": [w], "seed": seed}
                for w in frontier_grid().workloads]
        out.append({"grid": "mixed", "seed": seed})
        out.append({"workloads": ["resnet50"], "workers": [4, 16],
                    "het": ["none", SERVICE_HET], "stragglers": ["none", SERVICE_STRAGGLER],
                    "sync_k": ["none", "3"], "faults": ["none", SERVICE_FAULT],
                    "seed": seed})
    return out


def serve_queries_on_card(device: str) -> None:
    """Part 1: the HTTP server over a service on ``device``, every query
    POSTed at once from its own client thread, each answer held against a
    direct sweep on the card and against the NumPy engine."""
    import threading

    from repro_torch.core import agreement as A
    from repro_torch.launch import serve_sweep

    queries = service_queries()
    srv = serve_sweep.make_server(port=0, window_s=0.5, device=device)
    if srv.service.device.type != torch.device(device).type:
        raise SystemExit(f"service on {srv.service.device}, not {device}")
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        answers: list = [None] * len(queries)

        def ask(i: int) -> None:
            answers[i] = A.http_query(port, queries[i])

        t0 = time.perf_counter()
        clients = [threading.Thread(target=ask, args=(i,)) for i in range(len(queries))]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        wall = time.perf_counter() - t0
        stats = A.http_get(port, "/stats")
    finally:
        srv.shutdown()
        srv.server_close()
        srv.service.close()
    worst_direct = worst_numpy = 0.0
    bitwise = True
    for doc, lines in zip(queries, answers):
        if lines is None or lines[-1].get("type") != "trailer":
            raise SystemExit(f"query {doc}: no answer")
        got = serve_sweep.table_from_wire(lines)
        direct = A.direct_table(doc, "torch", device)
        bitwise &= A.bit_identical(got, direct)
        worst_direct = max(worst_direct, A.assert_tables_agree(got, direct, A.COALESCED_RTOL))
        worst_numpy = max(worst_numpy, A.assert_tables_agree(
            got, A.direct_table(doc, "numpy"), A.BATCHED_RTOL))
    trailers = [lines[-1] for lines in answers]
    served = [t["qos"]["coalesced_queries"] for t in trailers]
    if max(served) < 2 or any(t["backend"] != "torch" for t in trailers):
        raise SystemExit(f"no coalesced torch group: {served}")
    lat = stats["latency"]
    print(f"  {len(queries)} queries ({sum(t['n_scenarios'] for t in trailers)} scenarios) "
          f"over HTTP in {wall:.3f} s; {stats['kernel_calls']} kernel calls, queries per "
          f"call (each query's group) {served}; coalesce factor "
          f"{stats['coalesce_factor']:.3f}", flush=True)
    print(f"  against a direct sweep on {device}: "
          f"{'bit for bit' if bitwise else 'not bit for bit'}, worst relative "
          f"{worst_direct:.3e} (limit {A.COALESCED_RTOL:g}); against the NumPy engine "
          f"{worst_numpy:.3e} (limit {A.BATCHED_RTOL:g})", flush=True)
    print(f"  latency p50 {lat['p50_ms']:.3f} ms, p99 {lat['p99_ms']:.3f} ms (window "
          f"500 ms); {stats['sustained_scenarios_per_sec']:,.0f} scenarios/s over the "
          f"kernels' busy time; cache {stats['cache']}", flush=True)


def stream_on_card(grid, device: str) -> None:
    """Part 2: ``stream_csv`` of the frontier axes over the CNNs and this
    run's traces, read back and held to ``sweep()``'s rows."""
    from repro_torch.core import agreement as A

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        meta = A.stream_matches_sweep(grid, Path(tmp) / "frontier.csv", chunk=16384,
                                      device=device)
        total = time.perf_counter() - t0
    print(f"  streamed {meta['n_scenarios']} scenarios in {meta['n_chunks']} chunks of "
          f"16384 to CSV in {meta['elapsed_s']:.3f} s ({meta['scenarios_per_sec']:,.0f}/s), "
          f"read back equal to sweep() (with the check: {total:.3f} s)", flush=True)


def oracle_on_card(device: str) -> None:
    """Part 3: the card's rows of a small grid against the event-driven
    simulator, its sub-grids on a process pool of the host's cores."""
    import os

    from repro_torch.core import agreement as A
    from repro_torch.core.policies import ALL_POLICIES
    from repro_torch.core.scenarios import ScenarioGrid
    from repro_torch.core.sweep import sweep

    grid = ScenarioGrid(workloads=("resnet50", "trace:alexnet-k80"),
                        clusters=("v100-nvlink-ib",), worker_counts=ORACLE_WORKERS,
                        policies=tuple(ALL_POLICIES), collectives=("ring",),
                        het_profiles=(None, SERVICE_HET), sync_ks=(None, 3),
                        faults=(None, ORACLE_FAULT))
    jobs = os.cpu_count() or 1
    t0 = time.perf_counter()
    sim = A.simulated_table(grid, jobs=jobs)
    sim_s = time.perf_counter() - t0
    worst = A.assert_tables_agree(sweep(grid, device=device).columns, sim, A.BATCHED_RTOL,
                                  oracle=True)
    print(f"  oracle: {len(grid)} scenarios (workers {ORACLE_WORKERS}, ten policies, het, "
          f"sync_k, {ORACLE_FAULT}) on {device} against the event-driven simulator: worst "
          f"relative {worst:.3e} (limit {A.BATCHED_RTOL:g}); the simulator took {sim_s:.3f} s "
          f"on {jobs} processes", flush=True)


@phase("sweep service on the card")
def sweep_service_on_card(trace_dir: Path, device: str = "cuda") -> None:
    """Phase 10: the sweep service answering concurrent HTTP queries on the
    card, a 155 520-scenario grid streamed in chunks, and the card's rows
    against the event-driven simulator."""
    import dataclasses

    from repro_torch.core.scenarios import frontier_grid

    traces = tuple(f"torch:{trace_dir / f'{arch}.trace'}" for arch in MAIN_PATHS)
    frontier = frontier_grid()
    serve_queries_on_card(device)
    stream_on_card(dataclasses.replace(frontier, workloads=frontier.workloads + traces),
                   device)
    oracle_on_card(device)


# ----------------------------------------------------------------------
# 11. the paper's per-layer trace method on its CNNs (Table VI)
# ----------------------------------------------------------------------
#: Timed layers of the full-width traces.
CNN_LAYERS = {"alexnet": 11, "resnet50": 19}


def check_limit(what: str, sound: float, control: float, limit: float) -> None:
    """float32 within ``limit`` of scale, and the same layers in TF32 (the
    control) beyond it: otherwise the limit could not tell TF32 from
    float32."""
    print(f"  {what}: worst {sound:.3e} of its scale in float32, {control:.3e} in TF32 "
          f"(limit {limit:g})", flush=True)
    if not sound <= limit:
        raise SystemExit(f"{what}: float32 off by {sound:.3e} of scale (limit {limit:g})")
    if not control > limit:
        raise SystemExit(f"{what}: TF32 reads {control:.3e} of scale, within the limit "
                         f"{limit:g}: the check cannot see TF32")


def check_cnns_on_card() -> None:
    """The reduced CNNs (``table6_trace.reduced_networks``), batch 2: each
    layer's forward and the gradient of its sum in the parameters and the
    input on the card against the CPU (``generate.layer_errors``), from the
    same weights (drawn on the CPU from one seed) and inputs, in float32
    and, as the control, in TF32."""
    from repro_torch.examples.table6_trace import reduced_networks
    from repro_torch.traces.generate import F32_LIMIT, layer_errors

    cpu_nets = reduced_networks(torch.device("cpu"))
    for net, (build, batch) in reduced_networks(torch.device("cuda")).items():
        (cpu_layers, x0), (card_layers, _) = cpu_nets[net][0](), build()
        x = torch.randn((batch,) + tuple(x0.shape[1:]), generator=torch.Generator().manual_seed(1))
        x = x.contiguous(memory_format=torch.channels_last)
        sound, where = layer_errors(cpu_layers, card_layers, x)
        control, where_tf32 = layer_errors(cpu_layers, card_layers, x, tf32_on=True)
        check_limit(f"{net} reduced, {len(cpu_layers)} layers, card vs CPU (float32 worst at "
                    f"{where}, TF32 at {where_tf32})", sound, control, F32_LIMIT)


def share(bound_ms: float, ms: float) -> str:
    """The share of the bound a measured time reaches; a time below the
    bound says the layer did fewer operations than it counts."""
    if ms < bound_ms:
        return "< bound: fewer operations than a direct convolution"
    return f"= {bound_ms / ms:6.1%} of bound"


def cnn_layers_at_width(name: str, build, batch: int, records: list) -> None:
    """Each layer of a full-width trace, at the trace's shapes on N(0, 1)
    inputs (the trace times zeros, as the reference does): its forward
    against float64 on the card, in float32 and, as the control, in TF32
    (``check_limit``, of the output's scale); beside its float32 bound from
    the FLOPs of the forward and of the gradient call the backward column
    times (``torch.utils.flop_counter``: a direct convolution's, so a
    layer cuDNN runs by FFT or Winograd can beat it) and the bytes (each
    input read once, each output written once), bound = max(FLOPs / 67
    TFLOP/s, bytes / 3.35 TB/s); and the forward's kernels on the device
    (``torch.profiler``: the algorithm cuDNN chose, device ms against the
    trace's wall ms)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.bench import device_times
    from repro_torch.models.transformer import map_leaves
    from repro_torch.traces.generate import F32_LIMIT, _leaves, tf32

    layers, x0 = build()
    x = torch.randn((batch,) + tuple(x0.shape[1:]), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    x = x.contiguous(memory_format=torch.channels_last)
    peak = PEAK_FLOPS[torch.float32]
    worst = control = 0.0
    with tf32(False):
        for layer, rec in zip(layers, records):
            with FlopCounterMode(display=False) as fwd_count, torch.no_grad():
                y = layer.apply(layer.params, x)
            with torch.no_grad():
                y64 = layer.apply(map_leaves(lambda _, t: t.double(), layer.params), x.double())
            with tf32(True), torch.no_grad():
                y_tf32 = layer.apply(layer.params, x)
            scale = max(float(y64.abs().max()), 1e-30)
            err = float((y.double() - y64).abs().max()) / scale
            err_tf32 = float((y_tf32.double() - y64).abs().max()) / scale
            worst, control = max(worst, err), max(control, err_tf32)
            del y64, y_tf32
            p_bytes = sum(t.numel() * t.element_size() for t in _leaves(layer.params))
            f_bytes = (x.numel() + y.numel()) * 4 + p_bytes
            # the gradient call reads x, the parameters and dy, writes dx and
            # the parameters' gradients
            b_bytes = (2 * x.numel() + y.numel()) * 4 + 2 * p_bytes
            b_flops = 0
            if rec["size_bytes"]:
                params = map_leaves(lambda _, t: t.detach().requires_grad_(True), layer.params)
                xi = x.detach().requires_grad_(True)
                with FlopCounterMode(display=False) as bwd_count:
                    torch.autograd.grad(layer.apply(params, xi).sum(), _leaves(params) + [xi])
                b_flops = bwd_count.get_total_flops()
                del params, xi
            f_flops = fwd_count.get_total_flops()
            f_bound = max(f_flops / peak, f_bytes / PEAK_BYTES_PER_S) * 1e3
            by = "operations" if f_flops / peak > f_bytes / PEAK_BYTES_PER_S else "bytes"
            b_bound = max(b_flops / peak, b_bytes / PEAK_BYTES_PER_S) * 1e3 if b_flops else 0.0
            f_ms, b_ms = rec["forward_us"] / 1e3, rec["backward_us"] / 1e3

            def forward(layer=layer, x=x):
                with torch.no_grad():
                    layer.apply(layer.params, x)
                torch.cuda.synchronize()

            # the profiler can drop every record of a call late in a long
            # process; then no device time is claimed
            times = device_times(forward)
            top = sorted(times.items(), key=lambda kv: -kv[1])[:2]
            device = (f"device {sum(times.values()):7.4f} ms in {len(times)} kernels" if times
                      else "the profiler recorded no kernel")
            print(f"  {name:8s} {rec['name']:6s} vs f64 {err:.2e} (TF32 {err_tf32:.2e}); fwd "
                  f"{f_flops / 1e9:8.2f} GFLOP {f_bytes / 1e6:7.1f} MB bound {f_bound:7.4f} ms "
                  f"({by}) measured {f_ms:7.4f} ms {share(f_bound, f_ms)}, {device}; bwd "
                  f"{b_flops / 1e9:8.2f} GFLOP bound {b_bound:7.4f} ms measured {b_ms:7.4f} ms"
                  + (f" {share(b_bound, b_ms)}" if b_ms else ""), flush=True)
            for kname, ms in top:
                print(f"      {ms:8.4f} ms  {kname[:100]}", flush=True)
            x = y
    del layers, x0, x, y
    torch.cuda.empty_cache()
    check_limit(f"{name} at full width, layer outputs vs float64", worst, control, F32_LIMIT)


@phase("CNN traces (Table VI)")
def cnn_traces(trace_dir: Path) -> None:
    """The reduced CNNs against the CPU, then Table VI's totals and fresh
    full-width traces (AlexNet at 224, batch 1024; ResNet-50 at 224, batch
    32; ``python -m repro_torch.examples.table6_trace``), each read back,
    its layers checked against float64 and set beside their bounds
    (:func:`cnn_layers_at_width`), resolved through
    ``trace:<file>`` and predicted on 8 V100s under Caffe-MPI beside Table
    VI's own trace."""
    from repro_torch.core.hardware import CLUSTERS
    from repro_torch.core.policies import CAFFE_MPI
    from repro_torch.core.predictor import predict_workload
    from repro_torch.examples.table6_trace import networks, run

    check_cnns_on_card()
    print(card_line(), flush=True)
    out = run(trace_dir / "table6", device="cuda")
    if not out["roundtrip_ok"]:
        raise SystemExit("Table VI does not round-trip through the trace format")
    workloads = []
    for name, n_layers in CNN_LAYERS.items():
        doc = out["generated"][name]
        recs = doc["records"]
        bad = [r["name"] for r in recs
               if not (math.isfinite(r["forward_us"]) and r["forward_us"] > 0)
               or (r["size_bytes"] > 0) != (r["backward_us"] > 0)]
        if len(recs) != n_layers or bad:
            raise SystemExit(f"{name}: {len(recs)} layers (want {n_layers}); bad rows {bad}")
        workloads.append(f"trace:{doc['path']}")
        build, batch = networks(torch.device("cuda"))[name]
        cnn_layers_at_width(name, build, batch, recs)
    cluster = CLUSTERS["v100-nvlink-ib"]
    for wl in workloads + ["trace:alexnet-k80"]:
        p = predict_workload(wl, cluster, 8, CAFFE_MPI)
        print(f"  {wl.rsplit('/', 1)[-1]:20s} 8 x V100 caffe-mpi: {p.iteration_time:.6g} s/it, "
              f"speedup {p.speedup:.4g}, {p.samples_per_sec:.6g} samples/s", flush=True)
        if not (math.isfinite(p.iteration_time) and p.iteration_time > 0):
            raise SystemExit(f"{wl}: predicted {p.iteration_time}")


# ----------------------------------------------------------------------
# 12. the §V-D validation: per-layer costs -> DAG -> measured steps
# ----------------------------------------------------------------------
#: Timed steps a policy (the reference times 10; 3 took the script past
#: its 600 s aim on a call with slow gloo).
DAG_VALIDATION_STEPS = 2
#: The kernels its units must launch.
DAG_VALIDATION_KERNELS = ("flash_fwd", "flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkdv")


@phase("DAG validation (§V-D)")
def dag_validation() -> dict:
    """``python -m repro_torch.examples.dag_validation`` with
    ``DAG_VALIDATION_STEPS`` steps: qwen1.5-4b at its published widths, 2
    units, 2 gloo ranks on the card; prints the per-layer costs and
    ``RESULT``; returns the kernel launches (both ranks, counted from 0)."""
    from repro_torch.examples.dag_validation import GEOMETRY, run_validation

    doc = run_validation(GEOMETRY, steps=DAG_VALIDATION_STEPS, device="cuda")
    for r in doc["layers"]:
        print(f"  {r['name']:8s} fwd {r['forward_us'] / 1e3:9.4f} ms  bwd "
              f"{r['backward_us'] / 1e3:9.4f} ms  all-reduce {r['comm_s'] * 1e3:9.3f} ms  "
              f"{r['size_bytes'] / 1e6:9.3f} MB", flush=True)
    res = doc["result"]
    ideal = abs(res["predicted_wfbp_ideal_parallel_s"] - res["measured_wfbp_s"]) \
        / res["measured_wfbp_s"] * 100
    print(f"  t_update {doc['t_update_s'] * 1e3:.4f} ms; wfbp error with shared_compute "
          f"{res['prediction_error_pct']:.2f} %, without {ideal:.2f} %; launches "
          f"{doc['kernel_launches']}", flush=True)
    print("RESULT " + json.dumps(res, indent=2), flush=True)
    bad = [k for k, v in res.items()
           if not isinstance(v, str) and not (math.isfinite(v) and v > 0)]
    missing = [k for k in DAG_VALIDATION_KERNELS if doc["kernel_launches"].get(k, 0) <= 0]
    if bad or missing:
        raise SystemExit(f"DAG validation: bad {bad}; kernels not launched {missing}")
    return doc["kernel_launches"]


# ----------------------------------------------------------------------
# 13. decode on the card: KV and ring-buffer caches, the scans at one token
# ----------------------------------------------------------------------
#: arch -> (layers at the published widths, tokens of the float32 check:
#: prompt + generation).  gemma3-1b's 600 tokens pass its 512-token window,
#: so that its L blocks' ring buffers wrap.
DECODE_PATHS = {"qwen1.5-4b": (2, 96), "recurrentgemma-2b": (3, 96), "rwkv6-1.6b": (2, 96),
                "gemma3-1b": (6, 600)}
DECODE_BATCH = 4
#: tokens generated greedily after the prompt (the rest are prefilled)
DECODE_GEN = 32
#: the bfloat16 timing: the prompt, then the timed decode steps
DECODE_PROMPT, DECODE_TIMED = 64, 32
#: decode against ``forward`` in float32: the f32 ``_tol`` of
#: tests/test_kernels.py, of the logits' scale
DECODE_F32_LIMIT = 2e-4
#: the port kernels each decode path must launch
DECODE_KERNELS = {"recurrentgemma-2b": ("rglru_fwd",), "rwkv6-1.6b": ("wkv6_fwd",)}


def _decode_config(arch: str, depth: int | None, dtype):
    """``arch`` at its published widths in ``dtype``, ``depth`` layers (its
    published depth for None)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=depth or cfg.num_layers, dtype=dtype).validate()


def decode_vs_forward(arch: str, depth: int, total: int) -> dict:
    """Float32 (TF32 off) at the published widths: ``prefill_via_decode`` of
    ``total - DECODE_GEN`` random tokens into a cache of ``total``, then
    ``DECODE_GEN`` greedy ``make_serve_step`` steps; the logits at every
    position against one ``forward`` over the same tokens (flash and
    full-sequence scans).  Returns the port kernels the decode launched
    (counted from 0; ``forward`` is not counted)."""
    from repro_torch import kernels
    from repro_torch.launch.steps import init_params, make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.traces.generate import tf32

    cfg = _decode_config(arch, depth, torch.float32)
    with tf32(False):
        params = init_params(cfg, seed=0, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(0)
        prompt_len = total - DECODE_GEN
        prompt = torch.randint(0, cfg.vocab_size, (DECODE_BATCH, prompt_len), generator=g,
                               device="cuda")
        serve = make_serve_step(cfg)
        kernels.reset_launches()
        logits, cache = T.prefill_via_decode(cfg, params, prompt, total)
        outs, fed = [logits], [prompt]
        for pos in range(prompt_len, total):
            token = outs[-1][:, -1].argmax(dim=-1)
            lg, cache = serve(params, {"cache": cache, "token": token, "pos": pos})
            outs.append(lg[:, None])
            fed.append(token[:, None])
        torch.cuda.synchronize()
        launched = {k: n for k, n in kernels.all_launches().items() if n}
        decoded = torch.cat(outs, dim=1)
        with torch.no_grad():
            full = T.forward(cfg, params, torch.cat(fed, dim=1))
        scale = float(full.abs().max())
        err = float((decoded - full).abs().max()) / scale
    ring = "" if not cfg.sliding_window else \
        f", ring buffers of {min(total, cfg.sliding_window)} slots" + \
        (", wrapped" if total > cfg.sliding_window else "")
    print(f"  {arch:18s} f32 decode of {total} tokens (batch {DECODE_BATCH}, {prompt_len} "
          f"prefilled, {DECODE_GEN} generated{ring}) vs forward: worst {err:.3e} of the "
          f"logits' scale {scale:.3e} (limit {DECODE_F32_LIMIT:g}); launches {launched}",
          flush=True)
    missing = [k for k in DECODE_KERNELS.get(arch, ()) if not launched.get(k)]
    if not (math.isfinite(err) and err <= DECODE_F32_LIMIT) or missing:
        raise SystemExit(f"{arch}: decode off forward by {err:.3e} of scale; "
                         f"kernels not launched {missing}")
    del params, cache, decoded, full, outs
    torch.cuda.empty_cache()
    return launched


def decode_timing(arch: str, depth: int) -> dict:
    """bfloat16 at the published widths, batch ``DECODE_BATCH``: after a
    ``DECODE_PROMPT``-token prefill and one warm-up step, ``DECODE_TIMED``
    greedy ``make_serve_step`` steps timed on the host clock
    (synchronised); the port kernel launches per decoded token (the
    wrappers' counters), and one step's CUDA kernels and device time
    (``torch.profiler``)."""
    from repro_torch import kernels
    from repro_torch.launch.steps import init_params, make_serve_step
    from repro_torch.models import transformer as T

    cfg = _decode_config(arch, depth, torch.bfloat16)
    params = init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (DECODE_BATCH, DECODE_PROMPT), generator=g,
                           device="cuda")
    logits, cache = T.prefill_via_decode(cfg, params, prompt, DECODE_PROMPT + DECODE_TIMED + 2)
    serve = make_serve_step(cfg)
    state = {"token": logits[:, -1].argmax(dim=-1), "pos": DECODE_PROMPT}

    def step():
        lg, _ = serve(params, {"cache": cache, **state})
        state["token"], state["pos"] = lg.argmax(dim=-1), state["pos"] + 1

    step()
    torch.cuda.synchronize()
    before = kernels.all_launches()
    t0 = time.perf_counter()
    for _ in range(DECODE_TIMED):
        step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    per_token = {k: (n - before[k]) / DECODE_TIMED for k, n in kernels.all_launches().items()
                 if n != before[k]}
    n_kernels, device_ms = _cuda_kernels(step)
    out = {"tokens_per_s": DECODE_BATCH * DECODE_TIMED / dt, "step_ms": dt / DECODE_TIMED * 1e3,
           "launches_per_token": per_token, "cuda_kernels_per_step": n_kernels,
           "device_ms_per_step": device_ms}
    print(f"  {arch:18s} bf16 decode: {out['tokens_per_s']:.1f} tokens/s (batch "
          f"{DECODE_BATCH}, {DECODE_TIMED} steps after {DECODE_PROMPT} prefilled), "
          f"{out['step_ms']:.3f} ms a step; port kernel launches a step {per_token}; one step "
          f"{n_kernels} CUDA kernels, {device_ms:.3f} ms of device time", flush=True)
    del params, cache, logits
    torch.cuda.empty_cache()
    return out


def time_decode_scans() -> None:
    """``rglru_fwd`` and ``wkv6_fwd`` at one token with a carried state
    (``RGLRU_DECODE``, ``WKV6_DECODE``), each against its plain version
    and its bound as in decode (the state read and written, no states or
    checkpoints kept)."""
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import wkv6 as wk

    x, r, i, lam, h0, _, _ = rglru_inputs(**RGLRU_DECODE, seed=1)
    bnd = rglru_bounds(**RGLRU_DECODE, save=False)["rglru_fwd"]
    print_row("decode", "rglru_fwd", {
        "ms": time_ms(lambda: rg.fwd(x, r, i, lam, h0)),
        "plain_ms": time_ms(lambda: rg.plain_fwd(x, r, i, lam, h0), iters=5),
        "bound_ms": bnd[0], "bound_by": bnd[1]})
    print_profile("decode rglru_fwd's CUDA kernels (L2 warm)",
                  device_times(lambda: rg.fwd(x, r, i, lam, h0)))
    rr, k, v, w, u, st, _, _ = wkv6_inputs(**WKV6_DECODE, seed=1)
    bnd = wkv6_bounds(**WKV6_DECODE, save=False)["wkv6_fwd"]
    print_row("decode", "wkv6_fwd", {
        "ms": time_ms(lambda: wk.fwd(rr, k, v, w, u, st)),
        "plain_ms": time_ms(lambda: wk.plain_fwd(rr, k, v, w, u, st), iters=5),
        "bound_ms": bnd[0], "bound_by": bnd[1]})
    print_profile("decode wkv6_fwd's CUDA kernels (L2 warm)",
                  device_times(lambda: wk.fwd(rr, k, v, w, u, st)))


@phase("decode on the card")
def decode_on_card(card: str) -> dict:
    """Serving at the published widths with the depth cut
    (``DECODE_PATHS``): decode against ``forward`` in float32, then decode
    timed in bfloat16, then the two scans at one token.  Returns the port
    kernels the float32 decode runs launched."""
    launches: dict[str, int] = {}
    for arch, (depth, total) in DECODE_PATHS.items():
        for name, n in decode_vs_forward(arch, depth, total).items():
            launches[name] = launches.get(name, 0) + n
    print(card, flush=True)
    for arch, (depth, _) in DECODE_PATHS.items():
        decode_timing(arch, depth)
    time_decode_scans()
    return launches


# ----------------------------------------------------------------------
# 14. the training launcher
# ----------------------------------------------------------------------
#: ``python -m repro_torch.launch.train`` at gemma3-1b's full 26 layers and
#: published widths, AdamW
TRAIN_ARGS = ["--arch", "gemma3-1b", "--full", "--optimizer", "adamw", "--steps", "3",
              "--seq", "1024", "--batch", "4", "--log-every", "1", "--device", "cuda"]
#: the data-parallel run: 2 gloo ranks on the card, reduced widths
TRAIN_DP_ARGS = ["--arch", "gemma3-1b", "--steps", "4", "--data-parallel", "2", "--policy",
                 "wfbp", "--device", "cuda"]


@phase("train launcher")
def train_launcher() -> dict:
    """``TRAIN_ARGS`` with ``--checkpoint``: the loss finite, and
    ``restore_checkpoint`` gives back every parameter and optimizer leaf
    bit for bit; then ``TRAIN_DP_ARGS``.  Returns the kernels the first
    run launched (counted from 0)."""
    from repro_torch import kernels
    from repro_torch.checkpoint.ckpt import restore_checkpoint
    from repro_torch.launch import train as TR
    from repro_torch.models.transformer import leaf_order

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        ck = Path(tmp) / "ck.npz"
        kernels.reset_launches()
        summary, params, opt_state = TR.train_loop(
            TR.build_argparser().parse_args(TRAIN_ARGS + ["--checkpoint", str(ck)]),
            torch.device("cuda"))
        torch.cuda.synchronize()
        launches = {k: n for k, n in kernels.all_launches().items() if n}
        print(f"  {json.dumps(summary)}; checkpoint {ck.stat().st_size / 1e9:.3f} GB; "
              f"launches {launches}", flush=True)
        t0 = time.perf_counter()
        r_params, r_opt, meta = restore_checkpoint(ck, params, opt_state)
        t_restore = time.perf_counter() - t0
    differ = [("/".join(path), str(a.dtype)) for tree, back in ((params, r_params),
                                                                (opt_state, r_opt))
              for (path, a), (_, b) in zip(leaf_order(tree), leaf_order(back))
              if a.dtype != b.dtype or not torch.equal(a, b)]
    n_leaves = len(list(leaf_order(params))) + len(list(leaf_order(opt_state)))
    print(f"  restored {n_leaves} leaves in {t_restore:.1f} s (step {meta['step']}): "
          f"{n_leaves - len(differ)} bit for bit", flush=True)
    if not all(math.isfinite(summary[k]) for k in ("loss_first", "loss_last")) or differ \
            or meta["step"] != summary["steps"]:
        raise SystemExit(f"train launcher: {summary}; leaves not restored {differ}")
    if not launches.get("flash_fwd") or not launches.get("flash_bwd_dkdv"):
        raise SystemExit(f"train launcher: flash kernels not launched {launches}")
    del params, opt_state, r_params, r_opt
    torch.cuda.empty_cache()
    dp = TR.run(TR.build_argparser().parse_args(TRAIN_DP_ARGS))
    if dp["world"] != 2 or not math.isfinite(dp["loss_last"]):
        raise SystemExit(f"data-parallel launcher: {dp}")
    return launches


# ----------------------------------------------------------------------
# 15. remat and gradient accumulation
# ----------------------------------------------------------------------
#: accumulation against one batch in bfloat16: the bf16 limit of
#: tests/test_kernels.py, of each leaf's scale
ACCUM_BF16_LIMIT = 3e-2


@phase("remat and accumulation")
def remat_and_accumulation() -> None:
    """``make_train_step`` on one gemma3-1b unit (``LLLLLG``) at the
    published widths, bfloat16, batch 4 x 1024, SGD with momentum from
    zero (so the momentum after one step is the gradient, exactly):
    ``remat=True`` against ``remat=False`` bit for bit, with the flash
    forward launched twice as often; ``accum_steps=2`` against one batch
    within ``ACCUM_BF16_LIMIT`` of each leaf's scale."""
    from repro_torch import kernels
    from repro_torch.launch.steps import init_params, make_train_step
    from repro_torch.models.transformer import leaf_order
    from repro_torch.optim.sgd import sgd

    cfg = _decode_config("gemma3-1b", 6, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(2)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 1024), generator=g, device="cuda")
             for k in ("tokens", "labels")}
    runs = {}
    for remat, accum in ((False, 1), (True, 1), (True, 2)):
        params = init_params(cfg, seed=0, device="cuda")
        opt = sgd(1e-2, momentum=0.9)
        state = opt.init(params)
        kernels.reset_launches()
        _, state, metrics = make_train_step(cfg, opt, remat=remat, accum_steps=accum)(
            params, state, batch)
        torch.cuda.synchronize()
        runs[remat, accum] = (state["mom"], metrics, kernels.all_launches())
        del params
    (m0, met0, l0), (m1, met1, l1), (m2, met2, _) = runs.values()
    differ = ["/".join(p) for (p, a), (_, b) in zip(leaf_order(m0), leaf_order(m1))
              if not torch.equal(a, b)]
    worst, leaf = max((float((b - a).abs().max()) / max(float(a.abs().max()), 1e-30),
                       "/".join(p)) for (p, a), (_, b) in zip(leaf_order(m0), leaf_order(m2)))
    print(f"  remat: {len(differ)} of {len(list(leaf_order(m0)))} gradient leaves differ from "
          f"no remat, loss {float(met1['loss']):.6f} vs {float(met0['loss']):.6f}; flash_fwd "
          f"launches {l1['flash_fwd']} with remat, {l0['flash_fwd']} without", flush=True)
    print(f"  accum_steps 2 vs 1: worst leaf {leaf} {worst:.3e} of its scale (limit "
          f"{ACCUM_BF16_LIMIT:g}); loss {float(met2['loss']):.6f} vs {float(met0['loss']):.6f}",
          flush=True)
    if differ or not torch.equal(met0["loss"], met1["loss"]) or \
            l1["flash_fwd"] != 2 * l0["flash_fwd"] or \
            any(l1[k] != l0[k] for k in ("flash_bwd_dq", "flash_bwd_dkdv")):
        raise SystemExit(f"remat changes the gradient ({differ}) or the launches {l0} {l1}")
    if not worst <= ACCUM_BF16_LIMIT:
        raise SystemExit(f"accumulation off one batch by {worst:.3e} at {leaf}")


# ----------------------------------------------------------------------
# 16. the encoder-decoder path: whisper-tiny and llama-3.2-vision-90b
# ----------------------------------------------------------------------
#: whisper-tiny on the card against the CPU, float32: batch, decoder tokens
WHISPER_CHECK = (2, 64)
#: whisper-tiny's bfloat16 training: batch, tokens (its 448-token text
#: context), AdamW steps
WHISPER_TRAIN = (8, 448, 3)
#: whisper-tiny's decode: batch, prefilled tokens, decode steps (bfloat16
#: timed); the float32 check against ``forward`` prefills and generates
#: half as many
WHISPER_DECODE = (4, 16, 48)
#: llama-3.2-vision-90b at its published widths cut to one GGGGC unit: the
#: bfloat16 training step's tokens (batch 1) and the float32 decode's
#: tokens (batch 2, prefilled then generated half and half)
LLAMA_TRAIN_SEQ = 4096
LLAMA_DECODE_TOKENS = 32
#: the card against the CPU, and decode against ``forward``, in float32:
#: the f32 ``_tol`` of tests/test_kernels.py, of each tensor's scale
ENCDEC_F32_LIMIT = 2e-4


def _encoder_input(cfg, batch: int, gen: torch.Generator, device="cuda") -> torch.Tensor:
    """Stub frames (whisper) or image embeddings (llama-vision), N(0, 1)."""
    n = cfg.encoder_seq or cfg.num_image_tokens
    return torch.randn(batch, n, cfg.d_model, generator=gen, device=device).to(cfg.dtype)


def whisper_card_vs_cpu() -> dict:
    """whisper-tiny at its published widths and depth (4 + 4 layers), float32
    (TF32 off), ``WHISPER_CHECK`` tokens over 1500 frames: the logits, the
    loss and every gradient leaf (the encoder's included) through the
    kernels on the card against the plain versions on the CPU, within
    ``ENCDEC_F32_LIMIT`` of each tensor's scale (``worst_leaf``).  Returns
    the kernels the card side launched."""
    from repro_torch import kernels
    from repro_torch.launch.steps import init_params, loss_and_grads
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as T
    from repro_torch.traces.generate import tf32

    cfg = _decode_config("whisper-tiny", None, torch.float32)
    B, S = WHISPER_CHECK
    g = torch.Generator().manual_seed(3)
    tokens, labels = (torch.randint(0, cfg.vocab_size, (B, S), generator=g) for _ in range(2))
    frames = _encoder_input(cfg, B, g, "cpu")
    params = init_params(cfg, seed=0)
    threads = torch.get_num_threads()
    torch.set_num_threads(MODEL_CHECK_THREADS)
    out = {}
    with tf32(False):
        for dev in ("cpu", "cuda"):
            p = T.map_leaves(lambda _, t: t.to(dev), params)
            kernels.reset_launches()
            with torch.no_grad():
                logits = ED.forward(cfg, p, frames.to(dev), tokens.to(dev))
            total, _, grads = loss_and_grads(cfg, p, tokens.to(dev), labels.to(dev),
                                             encoder_in=frames.to(dev))
            out[dev] = (logits.cpu(), float(total), [t.cpu() for _, t in T.leaf_order(grads)])
            launched = {k: n for k, n in kernels.all_launches().items() if n}
            del p, logits, grads
    torch.set_num_threads(threads)
    (lg_cpu, l_cpu, g_cpu), (lg_gpu, l_gpu, g_gpu) = out["cpu"], out["cuda"]
    scale = float(lg_cpu.abs().max())
    err = float((lg_gpu - lg_cpu).abs().max()) / scale
    paths = ["/".join(map(str, path)) for path, _ in T.leaf_order(params)]
    worst, leaf = worst_leaf(paths, g_cpu, g_gpu)
    print(f"  whisper-tiny f32 (4 + 4 layers, batch {B}, {S} tokens, 1500 frames) card vs "
          f"CPU: logits {err:.3e} of scale {scale:.3e}; loss {l_gpu:.6f} vs {l_cpu:.6f}; "
          f"worst of {len(paths)} gradient leaves {leaf} {worst:.3e} (limit "
          f"{ENCDEC_F32_LIMIT:g}); card launches {launched}", flush=True)
    if not (err <= ENCDEC_F32_LIMIT and worst <= ENCDEC_F32_LIMIT
            and abs(l_gpu - l_cpu) <= ENCDEC_F32_LIMIT * abs(l_cpu)):
        raise SystemExit(f"whisper-tiny on the card disagrees with the CPU: logits {err:.3e}, "
                         f"{leaf} {worst:.3e}, loss {l_gpu} vs {l_cpu}")
    # the logits' forward and the loss's: each encoder layer one launch,
    # each C layer two (self and cross); the backward one dk/dv each
    want = {"flash_fwd": 2 * (cfg.encoder_layers + 2 * cfg.num_layers),
            "flash_bwd_dkdv": cfg.encoder_layers + 2 * cfg.num_layers}
    if any(launched.get(k) != n for k, n in want.items()):
        raise SystemExit(f"whisper-tiny launches {launched}, want {want}")
    return launched


def whisper_train_bf16() -> None:
    """whisper-tiny at its published widths, bfloat16: ``WHISPER_TRAIN``
    ``make_train_step`` steps (AdamW, ``remat`` on), frames and tokens from
    a seed; each step's ms (host clock, synchronised; the first includes
    cuBLAS's set-up) and the peak device memory."""
    from repro_torch.launch.steps import init_params, make_train_step
    from repro_torch.optim.sgd import adamw

    cfg = _decode_config("whisper-tiny", None, torch.bfloat16)
    B, S, steps = WHISPER_TRAIN
    g = torch.Generator(device="cuda").manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda"),
             "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda"),
             "frames": _encoder_input(cfg, B, g)}
    params = init_params(cfg, seed=0, device="cuda")
    opt = adamw(1e-4)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"  whisper-tiny bf16 train (batch {B} x {S} tokens, 1500 frames, AdamW, remat): "
          f"ms a step {[round(t, 3) for t in times]}, losses {[round(x, 4) for x in losses]}, "
          f"peak memory {peak:.2f} GB", flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"whisper-tiny training: losses {losses}")
    del params, state, batch
    torch.cuda.empty_cache()


def encdec_decode_vs_forward(arch: str, dtype, batch: int, prompt: int, gen: int,
                             num_layers: int | None = None) -> tuple[float, dict]:
    """``prefill_via_decode`` of ``prompt`` tokens then ``gen`` greedy
    ``make_serve_step`` steps (the encoder states computed once), against
    one ``forward`` over the same tokens: (the worst logit error over the
    logits' scale, the port kernels the decode launched)."""
    from repro_torch import kernels
    from repro_torch.launch.steps import init_params, make_serve_step
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as T

    cfg = _decode_config(arch, num_layers, dtype)
    g = torch.Generator(device="cuda").manual_seed(5)
    params = init_params(cfg, seed=0, device="cuda")
    enc_in = _encoder_input(cfg, batch, g)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g, device="cuda")
    audio = cfg.arch_type == "audio"
    decoder = params["decoder"] if audio else params
    with torch.no_grad():
        enc = ED.encode(cfg, params["encoder"], enc_in) if audio else enc_in
    kernels.reset_launches()
    logits, cache = T.prefill_via_decode(cfg, decoder, tokens, prompt + gen, encoder_out=enc)
    serve = make_serve_step(cfg)
    outs, fed = [logits], [tokens]
    for pos in range(prompt, prompt + gen):
        token = outs[-1][:, -1].argmax(dim=-1)
        lg, cache = serve(params, {"cache": cache, "token": token, "pos": pos,
                                   ("encoder_states" if audio else "images"): enc})
        outs.append(lg[:, None])
        fed.append(token[:, None])
    torch.cuda.synchronize()
    launched = {k: n for k, n in kernels.all_launches().items() if n}
    with torch.no_grad():
        full = T.forward(cfg, decoder, torch.cat(fed, dim=1), encoder_out=enc)
    decoded = torch.cat(outs, dim=1)
    scale = float(full.abs().max())
    err = float((decoded - full).abs().max()) / scale
    del params, decoder, cache, enc, full, decoded, outs
    torch.cuda.empty_cache()
    return err, launched


def whisper_decode_timing() -> dict:
    """bfloat16, ``WHISPER_DECODE``: the encoder states computed once, a
    prefill, one warm-up step, then the decode steps timed on the host
    clock (synchronised): tokens/s, ms a step, the port kernel launches a
    token and one step's CUDA kernels and device time."""
    from repro_torch import kernels
    from repro_torch.launch.steps import init_params, make_serve_step
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as T

    cfg = _decode_config("whisper-tiny", None, torch.bfloat16)
    B, prompt, steps = WHISPER_DECODE
    g = torch.Generator(device="cuda").manual_seed(6)
    params = init_params(cfg, seed=0, device="cuda")
    t0 = time.perf_counter()
    with torch.no_grad():
        enc = ED.encode(cfg, params["encoder"], _encoder_input(cfg, B, g))
    torch.cuda.synchronize()
    t_encode = (time.perf_counter() - t0) * 1e3
    tokens = torch.randint(0, cfg.vocab_size, (B, prompt), generator=g, device="cuda")
    logits, cache = T.prefill_via_decode(cfg, params["decoder"], tokens, prompt + steps + 2,
                                         encoder_out=enc)
    serve = make_serve_step(cfg)
    state = {"token": logits[:, -1].argmax(dim=-1), "pos": prompt}

    def step():
        lg, _ = serve(params, {"cache": cache, "encoder_states": enc, **state})
        state["token"], state["pos"] = lg.argmax(dim=-1), state["pos"] + 1

    step()
    torch.cuda.synchronize()
    before = kernels.all_launches()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    per_token = {k: (n - before[k]) / (steps - 1) for k, n in kernels.all_launches().items()
                 if n != before[k]}
    n_kernels, device_ms = _cuda_kernels(step)
    out = {"tokens_per_s": B * (steps - 1) / dt, "step_ms": dt / (steps - 1) * 1e3}
    print(f"  whisper-tiny bf16 decode: encoder states {t_encode:.3f} ms (batch {B}, 1500 "
          f"frames, once); {out['tokens_per_s']:.1f} tokens/s ({steps - 1} steps after "
          f"{prompt} prefilled and one warm-up), {out['step_ms']:.3f} ms a step; port kernel "
          f"launches a step {per_token}; one step {n_kernels} CUDA kernels, {device_ms:.3f} ms "
          f"of device time", flush=True)
    if per_token.get("flash_fwd") != cfg.num_layers:
        raise SystemExit(f"whisper-tiny decode: flash launches a step {per_token}")
    del params, cache, enc
    torch.cuda.empty_cache()
    return out


def llama_train_step() -> dict:
    """llama-3.2-vision-90b at its published widths, one GGGGC unit (5
    layers, 6.53 G parameters with the embedding and the untied head),
    bfloat16: one ``make_train_step`` step (SGD with momentum, ``remat``
    on) at batch 1 x ``LLAMA_TRAIN_SEQ`` tokens and 1601 image tokens; its
    ms (host clock, synchronised, cuBLAS's set-up included) and the peak
    device memory.  Returns the port kernels it launched."""
    from repro_torch import kernels
    from repro_torch.launch.steps import init_params, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim.sgd import sgd

    cfg = _decode_config("llama-3.2-vision-90b", 5, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(7)
    batch = {k: torch.randint(0, cfg.vocab_size, (1, LLAMA_TRAIN_SEQ), generator=g,
                              device="cuda") for k in ("tokens", "labels")}
    batch["images"] = _encoder_input(cfg, 1, g)
    params = init_params(cfg, seed=0, device="cuda")
    n_params = T.param_count(params)
    opt = sgd(1e-3, momentum=0.9)
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    params, state, metrics = make_train_step(cfg, opt)(params, state, batch)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    launched = {k: n for k, n in kernels.all_launches().items() if n}
    print(f"  llama-3.2-vision-90b bf16 train step (one GGGGC unit, {n_params / 1e9:.3f} G "
          f"parameters; batch 1 x {LLAMA_TRAIN_SEQ} tokens, 1601 image tokens; SGD, remat): "
          f"{ms:.1f} ms, loss {loss:.4f}, grad norm {float(metrics['grad_norm']):.4f}, peak "
          f"memory {peak:.2f} GB; launches {launched}", flush=True)
    if not math.isfinite(loss) or launched.get("flash_fwd") != 2 * 6 \
            or launched.get("flash_bwd_dkdv") != 6:
        raise SystemExit(f"llama-3.2-vision-90b training: loss {loss}, launches {launched}")
    del params, state, batch, metrics
    torch.cuda.empty_cache()
    return launched


@phase("encoder-decoder on the card")
def encdec_on_card(card: str) -> dict:
    """whisper-tiny (full width and depth) on the card against the CPU in
    float32, trained in bfloat16, decoded against ``forward`` in float32
    and timed in bfloat16; llama-3.2-vision-90b at its published widths cut
    to one GGGGC unit: one bfloat16 training step, and a float32 decode
    against ``forward``.  Returns the port kernels the float32 checks,
    the float32 decodes and the training step launched."""
    from repro_torch.traces.generate import tf32

    launches: dict[str, int] = {}

    def add(counts: dict) -> None:
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    add(whisper_card_vs_cpu())
    print(card, flush=True)
    whisper_train_bf16()
    B, prompt, steps = WHISPER_DECODE
    with tf32(False):
        err, launched = encdec_decode_vs_forward("whisper-tiny", torch.float32, B, prompt // 2,
                                                 steps // 2)
    print(f"  whisper-tiny f32 decode of {(prompt + steps) // 2} tokens (batch {B}) vs "
          f"forward: worst {err:.3e} of the logits' scale (limit {ENCDEC_F32_LIMIT:g}); "
          f"launches {launched}", flush=True)
    if not err <= ENCDEC_F32_LIMIT:
        raise SystemExit(f"whisper-tiny decode off forward by {err:.3e}")
    add(launched)
    whisper_decode_timing()
    add(llama_train_step())
    half = LLAMA_DECODE_TOKENS // 2
    with tf32(False):
        err, launched = encdec_decode_vs_forward("llama-3.2-vision-90b", torch.float32, 2,
                                                 half, half, num_layers=5)
    print(f"  llama-3.2-vision-90b f32 decode of {LLAMA_DECODE_TOKENS} tokens (batch 2, one "
          f"GGGGC unit, 1601 image tokens) vs forward: worst {err:.3e} of the logits' scale "
          f"(limit {ENCDEC_F32_LIMIT:g}); launches {launched}", flush=True)
    if not err <= ENCDEC_F32_LIMIT or launched.get("flash_fwd") != LLAMA_DECODE_TOKENS:
        raise SystemExit(f"llama-3.2-vision-90b decode off forward by {err:.3e}, "
                         f"launches {launched}")
    add(launched)
    return launches


# ----------------------------------------------------------------------
# 17. the dry run against the card
# ----------------------------------------------------------------------
#: arch -> layers: one unit of each at its published widths
DRYRUN_ARCHS = {"qwen1.5-4b": 1, "recurrentgemma-2b": 3, "rwkv6-1.6b": 1}
DRYRUN_BATCH, DRYRUN_SEQ = 2, 1024
#: the real step's peak against the dry run's arguments + temporaries
DRYRUN_PEAK_RTOL = 0.10


def real_train_step(cfg, batch: int, seq: int) -> dict:
    """One bfloat16 ``make_train_step`` step (SGD, momentum 0.9, remat) on
    the card from seed 0: its peak above what was allocated before its
    arguments were made, its FLOPs (``dryrun.flop_counter``), the port kernel
    launches (counted from 0) and the loss."""
    from repro_torch import kernels
    from repro_torch.launch.dryrun import flop_counter
    from repro_torch.launch.steps import init_params, make_train_step
    from repro_torch.optim.sgd import sgd

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = init_params(cfg, seed=0, device="cuda")
    opt = sgd(lr=1e-2, momentum=0.9)
    opt_state = opt.init(params)
    g = torch.Generator(device="cuda").manual_seed(0)
    data = {k: torch.randint(0, cfg.vocab_size, (batch, seq), generator=g, device="cuda",
                             dtype=torch.int32) for k in ("tokens", "labels")}
    step = make_train_step(cfg, opt, remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with flop_counter() as fc:
        _, _, metrics = step(params, opt_state, data)
    torch.cuda.synchronize()
    out = {"peak": torch.cuda.max_memory_allocated() - base, "flops": fc.get_total_flops(),
           "calls": {k: n for k, n in kernels.all_launches().items() if n},
           "loss": float(metrics["loss"])}
    del params, opt_state, data, metrics
    torch.cuda.empty_cache()
    return out


@phase("dry run against the card")
def dryrun_vs_card(card: str) -> dict:
    """``DRYRUN_ARCHS`` at one unit of their published widths, bfloat16,
    batch 2 x 1024, SGD with momentum 0.9, remat on: one real single-rank
    train step (:func:`real_train_step`), then the dry run of the same
    config and shapes (``repro_torch.launch.dryrun.lower``) on fake CUDA
    tensors and on the meta device, which must give the same record.  Fails
    if the real peak and the dry run's arguments + temporaries differ by
    more than ``DRYRUN_PEAK_RTOL``, or the FLOP totals or the kernel call
    counts differ at all.  Returns the real steps' launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.dryrun import lower

    print(f"  roofline constants, data-sheet peaks of an NVIDIA H100 80GB HBM3 at 700 W "
          f"(not measured): {PEAK_FLOPS[torch.bfloat16]:.3e} bf16 FLOP/s, "
          f"{PEAK_BYTES_PER_S:.3e} HBM B/s, {NVLINK_BYTES_PER_S:.3e} NVLink B/s a direction; "
          f"this card: {card}", flush=True)
    shape = InputShape("card_check", DRYRUN_SEQ, DRYRUN_BATCH, "train")
    launches: dict[str, int] = {}
    failed = []
    for arch, layers in DRYRUN_ARCHS.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=layers).validate()
        real = real_train_step(cfg, DRYRUN_BATCH, DRYRUN_SEQ)
        dry = {dev: lower(cfg, shape, device=dev) for dev in ("cuda", "meta")}
        same = all(dry["cuda"][k] == dry["meta"][k]
                   for k in ("memory", "cost_analysis", "kernel_calls"))
        d = dry["cuda"]
        mem = d["memory"]
        predicted = mem["argument_bytes"] + mem["temp_bytes"]
        ratio = real["peak"] / predicted
        print(f"  {arch:18s} ({layers} layers, bf16, {DRYRUN_BATCH} x {DRYRUN_SEQ}, SGD 0.9, "
              f"remat): peak on the card {real['peak']} B, dry run {mem['argument_bytes']} "
              f"arguments + {mem['temp_bytes']} temporaries = {predicted} B, ratio "
              f"{ratio:.4f}; FLOPs card {real['flops']}, dry run "
              f"{d['cost_analysis']['flops']}; kernel calls card {real['calls']}, dry run "
              f"{d['kernel_calls']}; lowered in {d['lower_s']} s (cuda) / "
              f"{dry['meta']['lower_s']} s (meta), the two records "
              f"{'equal' if same else 'DIFFER'}; loss {real['loss']:.4f}", flush=True)
        if not (abs(ratio - 1) <= DRYRUN_PEAK_RTOL and real["flops"] ==
                d["cost_analysis"]["flops"] and real["calls"] == d["kernel_calls"] and same
                and real["calls"] and math.isfinite(real["loss"])):
            failed.append(arch)
        for name, n in real["calls"].items():
            launches[name] = launches.get(name, 0) + n
    if failed:
        raise SystemExit(f"the dry run disagrees with the card for {failed}")
    return launches


#: the train_e2e twin as the reference's docstring runs it at full size
E2E_ARGS = ["--preset", "full", "--steps", "300", "--ckpt-every", "100"]


@phase("train_e2e (deliverable b)")
def train_e2e_on_card(card: str) -> dict:
    """``repro_torch.examples.train_e2e`` at ``E2E_ARGS`` into a temporary
    directory, the launch counters set to 0 just before; then its flash
    kernels timed at its ``L`` shape.  Returns the run's launches."""
    from repro_torch import kernels
    from repro_torch.examples import train_e2e

    print(f"  {card}", flush=True)
    losses: list[float] = []
    with tempfile.TemporaryDirectory() as out:
        args = train_e2e.parser().parse_args([*E2E_ARGS, "--out-dir", out])
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        report = train_e2e.run(args, "cuda", losses=losses)
        wall = time.perf_counter() - t0
        launches = {name: n for name, n in kernels.all_launches().items() if n}
        peak = torch.cuda.max_memory_allocated()
        files = sorted(p.name for p in Path(out).iterdir())
    print(f"  report.json {json.dumps(report)}", flush=True)
    print(f"  {len(losses)} steps in {wall:.1f} s, peak memory {peak} B; loss every 25 steps "
          f"{[round(x, 4) for x in losses[::25]]}, last {losses[-1]:.4f}; files {files}; "
          f"launches {launches}", flush=True)
    missing = [name for name in ("flash_fwd", "flash_bwd_dkdv") if not launches.get(name)]
    if missing or not all(math.isfinite(x) for x in losses) or len(losses) != 300:
        raise SystemExit(f"train_e2e: kernels not launched {missing} or a loss not finite")
    if files != ["ckpt_100.npz", "ckpt_200.npz", "ckpt_final.npz", "report.json"]:
        raise SystemExit(f"train_e2e wrote {files}")
    time_flash(E2E_L, "e2e_l")
    return launches


#: ``long_500k``: batch 1 at 524 288 tokens, the last four positions decoded
SEQ_DECODE_LEN = 524_288
SEQ_DECODE_ARCHS = ("gemma3-1b", "recurrentgemma-2b")
#: the bf16 kernel tolerance of ``tests/test_kernels.py`` (``_tol``)
SEQ_DECODE_TOL = 3e-2


@phase("sequence-sharded decode")
def seq_decode_on_card(card: str) -> dict:
    """``repro_torch.launch.seq_decode`` on 2 gloo ranks of this card for
    ``SEQ_DECODE_ARCHS`` at published widths and full depth, bf16, each
    rank's launch counters set to 0 before each sharded decode; each
    token's logits, cache and attention layers' combines against the
    one-rank decode, the control's combine beyond the limit, its ``Comm``
    counts against the dry run's ``long_500k`` / ``dp8`` record.  Returns
    the sharded decodes' launches of both ranks."""
    from repro_torch.launch import dryrun, seq_decode

    positions = list(range(SEQ_DECODE_LEN - 4, SEQ_DECODE_LEN))
    jobs = [{"arch": arch, "seq_len": SEQ_DECODE_LEN, "positions": positions}
            for arch in SEQ_DECODE_ARCHS]
    with tempfile.TemporaryDirectory() as out:
        results = seq_decode.run(jobs, 2, "cuda", out)
    print(f"  {card}", flush=True)
    launches: dict[str, int] = {}
    failed = []
    for i, arch in enumerate(SEQ_DECODE_ARCHS):
        rec = dryrun.dryrun_one(arch, "long_500k", ranks=8)
        col = rec["collectives"]
        print(f"  {arch}: dry run long_500k dp8 {rec['status']}, {col['total_count']} "
              f"all-reduces, {col['total_bytes']} B a token", flush=True)
        for rank, res in enumerate(r[i] for r in results):
            for st in res["steps"]:
                ok = (st["logits_err"] <= SEQ_DECODE_TOL and st["cache_err"] <= SEQ_DECODE_TOL
                      and st["attn_err"] <= SEQ_DECODE_TOL
                      and st["comm_bytes"] == col["total_bytes"]
                      and st["comm_calls"] == col["total_count"])
                print(f"  {arch:18s} rank {rank} pos {st['pos']}: logits {st['logits_err']:.3e}"
                      f" and cache {st['cache_err']:.3e} of scale from the one-rank decode; "
                      f"combine {st['attn_err']:.3e} of its layer's scale (worst at "
                      f"{st['attn_where']}), control {st['control_err']:.3e}; "
                      f"host {st['ms']:.3f} ms a token (one rank, whole cache: "
                      f"{st['one_rank_ms']:.3f}); Comm {st['comm_calls']} calls, "
                      f"{st['comm_bytes']} B{'' if ok else '  FAIL'}", flush=True)
                if not ok:
                    failed.append((arch, rank, st["pos"]))
            print(f"  {arch:18s} rank {rank} ({res['num_layers']} layers, {res['dtype']}): "
                  f"launches of the sharded decodes {res['launches']}", flush=True)
            if arch == "recurrentgemma-2b" and not res["launches"].get("rglru_fwd"):
                failed.append((arch, rank, "rglru_fwd not launched"))
            for name, n in res["launches"].items():
                launches[name] = launches.get(name, 0) + n
        for t, pos in enumerate(positions):
            control = max(r[i]["steps"][t]["control_err"] for r in results)
            if not control > SEQ_DECODE_TOL:
                failed.append((arch, pos, f"control {control:.3e} within the limit: the "
                               "combine check cannot see a dropped rank"))
        if rec["status"] != "ok":
            failed.append((arch, "dry run", rec.get("error")))
    if failed:
        raise SystemExit(f"sequence-sharded decode: {failed}")
    return launches


#: the sharded step's archs at the per-rank shapes of the dry-run phase, and
#: the kernels each must launch
SHARDED_ARCHS = {"recurrentgemma-2b": (3, ("rglru_fwd", "rglru_bwd", "flash_fwd",
                                           "flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkdv")),
                 "rwkv6-1.6b": (1, ("wkv6_fwd", "wkv6_bwd"))}
#: the tensor-parallel phase's archs on {data: 2, model: 2}: (layers, mode, the
#: kernels each must launch)
TP_ARCHS = {"recurrentgemma-2b": (3, "fsdp", SHARDED_ARCHS["recurrentgemma-2b"][1]),
            "rwkv6-1.6b": (1, "fsdp", SHARDED_ARCHS["rwkv6-1.6b"][1]),
            "qwen2-moe-a2.7b": (1, "pure_dp", ("flash_fwd", "flash_bwd_delta", "flash_bwd_dq",
                                               "flash_bwd_dkdv"))}


def sharded_jobs_on_card(card: str, jobs: list[dict], world: int, must: dict) -> dict:
    """``repro_torch.launch.sharded_step.run`` of ``jobs`` on ``world`` gloo
    ranks of this card; prints each job's dry run and each rank's record,
    fails on any finding of ``check`` or a kernel of ``must[arch]`` not
    launched on a rank.  Returns the ranks' launches."""
    from repro_torch.launch import sharded_step

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        results = sharded_step.run(jobs, world, "cuda", out)
    print(f"  {card}; {world} gloo ranks in {time.perf_counter() - t0:.1f} s (spawn, the "
          "steps, gathers, the dry runs)", flush=True)
    launches: dict[str, int] = {}
    failed = []
    for job, (ranks, dry, bad) in zip(jobs, results):
        arch = job["arch"]
        mem = dry["memory"]
        predicted = mem["argument_bytes"] + mem["temp_bytes"]
        print(f"  {arch:18s} dry run ({job['num_layers']} layers, {job['sizes']}, "
              f"{job['mode']}): {mem['argument_bytes']} B arguments + {mem['temp_bytes']} B "
              f"temporaries = {predicted} B; collectives {dry['collectives']['count_by_op']} "
              f"calls, {dry['collectives']['bytes_by_op']} B", flush=True)
        for res in ranks:
            print(f"  {arch:18s} rank {res['rank']} ({res['dtype']}): loss "
                  f"{res['metrics']['loss']:.6f} (pure_dp {res['pure_dp_metrics']['loss']:.6f}), "
                  f"grad_norm {res['metrics']['grad_norm']:.6f} (pure_dp "
                  f"{res['pure_dp_metrics']['grad_norm']:.6f}, {res['norm_err']:.3e}); worst "
                  f"parameter {res['params_err']:.3e} ({res['params_where']}), momentum "
                  f"{res['mom_err']:.3e} ({res['mom_where']}), control "
                  f"{res['control_mom_err']:.3e}; momentum bit for bit pure_dp's: "
                  f"{res['bitwise']}; peak {res['peak']} B, ratio to the dry run "
                  f"{res['peak'] / predicted:.4f}; collectives {res['count_by_op']} calls, "
                  f"{res['bytes_by_op']} B; launches {res['launches']}; seconds "
                  f"{ {k: round(v, 1) for k, v in res['seconds'].items()} }", flush=True)
            if "bf16" in res:
                w, mem16 = res["bf16"], dry["bf16"]["memory"]
                print(f"  {arch:18s} rank {res['rank']} bfloat16: momentum from float32 "
                      f"pure_dp's: pure_dp {w['pure_dp_err']:.3e} ({w['pure_dp_where']}), the "
                      f"mode {w['mode_err']:.3e} ({w['mode_where']}), ratio "
                      f"{w['mode_err'] / w['pure_dp_err']:.3f}; the mode from bfloat16 "
                      f"pure_dp's {w['mode_vs_pure_dp_err']:.3e} ({w['mode_vs_pure_dp_where']});"
                      f" peak {w['peak']} B, ratio to the bfloat16 dry run "
                      f"{w['peak'] / (mem16['argument_bytes'] + mem16['temp_bytes']):.4f}; "
                      f"collectives {w['count_by_op']} calls, {w['bytes_by_op']} B",
                      flush=True)
            missing = [k for k in must[arch] if not res["launches"].get(k)]
            if missing:
                bad.append(f"rank {res['rank']}: kernels not launched {missing}")
            for name, n in res["launches"].items():
                launches[name] = launches.get(name, 0) + n
        failed += [f"{arch}: {b}" for b in bad]
    if failed:
        raise SystemExit(f"sharded step: {failed}")
    return launches


@phase("sharded step (zero3)")
def sharded_step_on_card(card: str) -> dict:
    """``repro_torch.launch.sharded_step`` on 2 gloo ranks of this card for
    ``SHARDED_ARCHS`` (module docstring, item 20).  Returns both ranks'
    launches of the zero3 steps."""
    jobs = [{"arch": arch, "num_layers": layers, "sizes": {"data": 2}, "mode": "zero3",
             "global_batch": 2 * DRYRUN_BATCH, "seq_len": DRYRUN_SEQ, "accum_steps": 1,
             "remat": True} for arch, (layers, _) in SHARDED_ARCHS.items()]
    return sharded_jobs_on_card(card, jobs, 2, {a: k for a, (_, k) in SHARDED_ARCHS.items()})


@phase("sharded step (fsdp)")
def tensor_parallel_step_on_card(card: str) -> dict:
    """``repro_torch.launch.sharded_step`` on 4 gloo ranks of this card on
    ``{data: 2, model: 2}`` for ``TP_ARCHS`` (module docstring, item 21).
    Returns the four ranks' launches."""
    sizes = {"data": 2, "model": 2}
    jobs = [{"arch": arch, "num_layers": layers, "sizes": sizes, "mode": mode,
             "global_batch": sizes["data"] * DRYRUN_BATCH, "seq_len": DRYRUN_SEQ,
             "accum_steps": 1, "remat": True, "dtype": "float32", "bf16_witness": True}
            for arch, (layers, mode, _) in TP_ARCHS.items()]
    # four ranks of whole published-width embeddings share the card: this
    # process gives back its cached blocks, and the ranks' allocators return
    # what a step frees (they inherit the setting)
    torch.cuda.empty_cache()
    old = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        return sharded_jobs_on_card(card, jobs, 4,
                                    {a: k for a, (_, _, k) in TP_ARCHS.items()})
    finally:
        if old is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = old


def check_measurement(doc: dict, trace_text: str) -> None:
    """The repository's own checks on a measured run: finite positive
    times, the trace's layer rows, the counted all-reduce bytes equal to
    the payload accounting for every policy."""
    for pol, t in doc["policy_times_s"].items():
        if not (math.isfinite(t) and t > 0):
            raise SystemExit(f"policy {pol}: bad step time {t}")
    # the same init and batch under each policy: the losses after the timed
    # steps differ only by the policies' rounding (bf16 vs f32 sums)
    losses = list(doc["policy_losses"].values())
    if not all(math.isfinite(x) for x in losses) or max(losses) - min(losses) > 1e-2 * max(losses):
        raise SystemExit(f"policy losses disagree: {doc['policy_losses']}")
    # at lr 1e-2 the bf16 weights barely move, so the loss says little of the
    # sync; the momentum sums the synchronized gradients of every step
    norms = doc["policy_momentum_norms"]
    worst_leaf, worst = "", 0.0
    for leaf in next(iter(norms.values())):
        vals = [norms[pol][leaf] for pol in norms]
        if not all(math.isfinite(x) and x > 0 for x in vals):
            raise SystemExit(f"momentum of {leaf}: {vals}")
        if (max(vals) - min(vals)) / max(vals) >= worst:
            worst_leaf, worst = leaf, (max(vals) - min(vals)) / max(vals)
    print(f"  momentum norms: worst leaf {worst_leaf} differs by {worst:.3e} across "
          f"policies (limit {MOMENTUM_RTOL:.0e})", flush=True)
    if worst > MOMENTUM_RTOL:
        raise SystemExit(f"policies disagree on the momentum of {worst_leaf}: "
                         f"{ {pol: norms[pol][worst_leaf] for pol in norms} }")
    if not (math.isfinite(doc["t_update_s"]) and doc["t_update_s"] > 0):
        raise SystemExit("bad t_update_s")
    for pol, chk in doc["bytes_crosscheck"].items():
        if chk["counted_bytes"] != chk["expected_bytes"]:
            raise SystemExit(f"{pol}: counted {chk['counted_bytes']} all-reduce bytes, "
                             f"expected {chk['expected_bytes']}")
    rows = [ln.split("\t") for ln in trace_text.splitlines()
            if ln and not ln.startswith("#")]
    if len(rows) != 1 + doc["num_units"] or rows[0][1] != "embed_head":
        raise SystemExit(f"trace rows {[r[1] for r in rows]}")
    for r in rows:
        vals = [float(x) for x in r[2:6]]
        if not all(math.isfinite(x) and x >= 0 for x in vals) or vals[3] <= 0:
            raise SystemExit(f"bad trace row {r}")
    brief = {k: doc[k] for k in ("policy_times_s", "policy_losses", "segments", "t_update_s",
                                 "allreduce_fit", "bytes_crosscheck", "kernel_launches",
                                 "peak_memory_bytes", "elapsed_s")}
    print(json.dumps(brief, indent=1), flush=True)


def main() -> int:
    from repro_torch import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)

    phase("build kernels")(kernels.load_libraries)()
    report_flash_build()
    report_rglru_build()
    report_wkv6_build()
    worst = {**check_kernels(), **check_rglru(), **check_wkv6()}
    check_model()
    check_determinism()
    timing = time_kernels()
    profile_units()

    launches: dict[str, int] = {}
    measured: dict[str, tuple[dict, dict]] = {}
    with tempfile.TemporaryDirectory() as trace_dir:
        for arch, (args, must) in MAIN_PATHS.items():
            measured[arch] = run_measure(arch, args, Path(trace_dir))
            counts = measured[arch][0]["kernel_launches"]
            print(f"  {arch}: launches {counts}", flush=True)
            missing = [name for name in must if counts.get(name, 0) <= 0]
            if missing:
                raise SystemExit(f"kernels not launched on the {arch} path: {missing}")
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
        report_model_vs_measured(measured)
        check_sweep(Path(trace_dir))
        sweep_service_on_card(Path(trace_dir))
        cnn_traces(Path(trace_dir))
        for name, n in dag_validation().items():
            launches[name] = launches.get(name, 0) + n
    for path_launches in (decode_on_card(card), train_launcher()):
        for name, n in path_launches.items():
            launches[name] = launches.get(name, 0) + n
    remat_and_accumulation()
    for phase_launches in (encdec_on_card(card), dryrun_vs_card(card),
                           train_e2e_on_card(card), seq_decode_on_card(card),
                           sharded_step_on_card(card), tensor_parallel_step_on_card(card)):
        for name, n in phase_launches.items():
            launches[name] = launches.get(name, 0) + n
    line = [{"name": name, "route": "cuda", "source": str(mod.SOURCE.relative_to(ROOT)),
             "replaces": REPLACES[mod.__name__.rsplit(".", 1)[1]], "launches": launches[name],
             "max_abs_err": worst[name], **timing[name]}
            for mod in kernels.kernel_modules() for name in mod.LAUNCHES]
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
