"""The wkv6 kernels' share of their roofline over the traced steps: the
least time of every ``wkv6_fwd`` and ``wkv6_bwd`` launch at the cell's shape
(:func:`bench.cost.kernels.wkv6_least_s`, float32 operations on the CUDA
cores, which bound both; launches from the program's wrapper counters, one
per wrapper call of three CUDA kernels) over the device time of every
kernel whose name holds ``wkv6``, from the profiler."""
from bench.cost.kernels import wkv6_least_s

HEAD = 64


def read(record):
    prof = record["profile"]
    launches = {k: n for k, n in prof.get("launches", {}).items() if k.startswith("wkv6_")}
    device_s = sum(s for name, (_, s) in prof.get("kernels", {}).items() if "wkv6" in name)
    if not any(launches.values()) or device_s <= 0:
        return None
    c, t = record["config"], record["traffic"]
    least = wkv6_least_s(t["rows"], t["seq_len"], c["d_model"] // HEAD, HEAD)
    return 100.0 * sum(n * least[k][0] for k, n in launches.items()) / device_s
