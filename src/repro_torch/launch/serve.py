"""Serving launcher: batched prefill + greedy decode on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --batch 4 --prompt-len 32 --gen 32 [--device cpu]

Counterpart of :mod:`repro.launch.serve`: the same arguments, the same
``prefill_via_decode`` of random prompts followed by a greedy decode loop,
and the same summary keys.  As in the reference, the model is always
``get_config(arch).reduced(num_layers=2)`` (``--reduced`` is accepted and
changes nothing), and an ``audio`` or ``vlm`` arch is served as its dense
``G`` backbone alone, as the reference does; full width, and the
encoder-decoder, are served through
:func:`repro_torch.launch.steps.make_serve_step`.  Runs on CUDA unless
``--device cpu`` is given, and raises without a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import dense_backbone, init_params, make_serve_step
from repro_torch.models import transformer as T


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS, default="rwkv6-1.6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--greedy", action="store_true", default=True)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default cuda; cpu must be asked for")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = dense_backbone(get_config(args.arch).reduced(num_layers=2))
    params = init_params(cfg, seed=0, device=device)
    max_len = args.prompt_len + args.gen
    gen = torch.Generator(device=device).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
                            device=device)

    t0 = time.perf_counter()
    logits, cache = T.prefill_via_decode(cfg, params, prompts, max_len)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    serve_step = make_serve_step(cfg)
    token = logits[:, -1, :].argmax(dim=-1)
    out_tokens = [token]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        lg, cache = serve_step(params, {"cache": cache, "token": token,
                                        "pos": args.prompt_len + i})
        token = lg.argmax(dim=-1)
        out_tokens.append(token)
    _sync(device)
    t_decode = time.perf_counter() - t0

    generated = torch.stack(out_tokens, dim=1)
    summary = {
        "arch": cfg.name, "batch": args.batch,
        "prompt_len": args.prompt_len, "generated": int(generated.shape[1]),
        "prefill_s": t_prefill,
        "decode_tok_per_s": args.batch * (args.gen - 1) / max(t_decode, 1e-9),
        "sample_tokens": generated[0, :8].tolist(),
    }
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
    sys.exit(0)
