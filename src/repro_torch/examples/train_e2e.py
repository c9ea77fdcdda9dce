"""End-to-end training run, twin of ``examples/train_e2e.py`` (the
reference's "deliverable (b)"): a gemma3-family decoder LM trained for a
few hundred steps with the prefetching pipeline, SGD with momentum and
periodic checkpoints, then a run report.

    PYTHONPATH=src python -m repro_torch.examples.train_e2e [--preset small|full] \\
        [--steps 300] [--lr 3e-3] [--out-dir results/train_e2e] [--ckpt-every 100] \\
        [--device cpu]

The twin does what the reference's code does, not what its docstring
promises: one step on one device (value and gradients of ``loss_fn``,
then the optimizer update; no remat, no accumulation, no gradient sync),
and no trace is written.  It writes ``ckpt_<i>.npz`` every
``--ckpt-every`` steps, ``ckpt_final.npz`` and ``report.json`` (the
reference's ten keys) into ``--out-dir``, and fails unless the mean of the
last ten losses is below the first, as the reference does.  The presets
are the reference's: ``small`` (4 layers, d 256) and ``full`` (12 layers,
d 512), both f32 with one kv head of 64 and a window of 64.

Runs on CUDA unless ``--device cpu`` is given, and raises without a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from repro_torch.checkpoint.ckpt import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.pipeline import PrefetchLoader, SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import transformer as T
from repro_torch.optim.sgd import sgd

PRESETS = {
    # ~100M params: 12 layers x d512 x ff2048, 32k vocab
    "full": dict(num_layers=12, d_model=512, num_heads=8, d_ff=2048,
                 vocab_size=32768, seq=256, batch=8),
    # ~14M params: fits a few hundred steps in CPU minutes
    "small": dict(num_layers=4, d_model=256, num_heads=4, d_ff=1024,
                  vocab_size=8192, seq=128, batch=8),
}


def config(preset: str):
    """The reference's ``get_config("gemma3-1b").reduced(...)`` for a preset."""
    ps = PRESETS[preset]
    return get_config("gemma3-1b").reduced(
        num_layers=ps["num_layers"], d_model=ps["d_model"], num_heads=ps["num_heads"],
        d_ff=ps["d_ff"], vocab_size=ps["vocab_size"])


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", choices=PRESETS, default="small")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--out-dir", default="results/train_e2e")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default cuda; cpu must be asked for")
    return ap


def run(args: argparse.Namespace, device=None, params=None,
        losses: list | None = None) -> dict:
    """Train as the reference's ``main`` does and return the report.
    ``params`` (the port's tree, e.g. the reference's ``PRNGKey(0)``
    parameters through :func:`repro_torch.models.transformer.from_reference`)
    replaces the initialisation from seed 0; it is trained in place.
    ``losses``, if given, receives every step's loss."""
    device = resolve_device(device)
    ps = PRESETS[args.preset]
    cfg = config(args.preset)
    if params is None:
        params = T.init_lm(cfg, seed=0, device=device)
    n_params = T.param_count(params)
    print(f"model: {cfg.name} {n_params / 1e6:.1f}M params "
          f"pattern={cfg.layer_pattern} x{cfg.num_units}")

    opt = sgd(args.lr, momentum=0.9)
    state = opt.init(params)
    loader = PrefetchLoader(SyntheticLMDataset(cfg.vocab_size, ps["seq"], ps["batch"], seed=11),
                            depth=2, device=device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    losses = [] if losses is None else losses
    times = []
    try:
        t_prev = time.perf_counter()
        for i, batch in zip(range(args.steps), loader):
            loss, _, grads = loss_and_grads(cfg, params, batch["tokens"], batch["labels"])
            params, state = opt.update(grads, state, params)
            loss = float(loss)
            now = time.perf_counter()
            losses.append(loss)
            times.append(now - t_prev)
            t_prev = now
            if i % 25 == 0 or i == args.steps - 1:
                print(f"step {i:4d} loss {loss:.4f} ({times[-1] * 1e3:.0f} ms/step)",
                      flush=True)
            if args.ckpt_every and i and i % args.ckpt_every == 0:
                save_checkpoint(out_dir / f"ckpt_{i}.npz", params, state, step=i)
    finally:
        loader.close()
    save_checkpoint(out_dir / "ckpt_final.npz", params, state, step=args.steps)

    warm = times[3:]
    report = {
        "preset": args.preset, "params_m": n_params / 1e6,
        "steps": args.steps,
        "loss_first": losses[0], "loss_min": min(losses),
        "loss_last_mean10": float(np.mean(losses[-10:])),
        "mean_step_ms": float(np.mean(warm)) * 1e3,
        "tokens_per_s": ps["batch"] * ps["seq"] / float(np.mean(warm)),
        "t_io_ms": loader.mean_t_io() * 1e3,
        "t_h2d_ms": loader.mean_t_h2d() * 1e3,
    }
    (out_dir / "report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    assert report["loss_last_mean10"] < report["loss_first"], "training did not reduce loss"
    return report


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    run(args, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
