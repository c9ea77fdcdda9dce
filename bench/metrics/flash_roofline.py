"""The flash kernels' share of their roofline over the traced steps: the
least time of every launch of ``flash_fwd``, ``flash_bwd_delta``,
``flash_bwd_dq`` and ``flash_bwd_dkdv`` at the cell's shape
(:func:`bench.cost.kernels.flash_least_s`, launches from the program's
wrapper counters) over the device time of every kernel whose name holds
``flash``, from the profiler.  At bfloat16 training shapes the operations
bound all but ``flash_bwd_delta``, which its bytes bound."""
from bench.cost.kernels import flash_least_s


def read(record):
    prof = record["profile"]
    launches = {k: n for k, n in prof.get("launches", {}).items() if k.startswith("flash_")}
    device_s = sum(s for name, (_, s) in prof.get("kernels", {}).items() if "flash" in name)
    if not any(launches.values()) or device_s <= 0:
        return None
    c, t = record["config"], record["traffic"]
    H = c["num_heads"]
    least = flash_least_s(t["rows"], t["seq_len"], H, c.get("num_kv_heads") or H,
                          c["d_model"] // H)
    return 100.0 * sum(n * least[k][0] for k, n in launches.items()) / device_s
