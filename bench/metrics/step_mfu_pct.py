"""The whole step's share of the card's bfloat16 peak over the traced
window: the FLOPs the window's steps need (:func:`bench.cost.step.
train_step_flops`, no recompute) over its seconds x 989 TFLOP/s."""
from bench.cost.peaks import BF16_FLOPS
from bench.cost.step import train_step_flops


def read(record):
    w, t = record["window"], record["traffic"]
    if record["platform"] != "gpu" or not w["steps"]:
        return None
    flops = w["steps"] * train_step_flops(record["config"], t["rows"], t["seq_len"])
    return 100.0 * flops / (w["seconds"] * BF16_FLOPS)
