"""Share of the traced steps' wall time in which no operation ran on the
device: 1 - (union of the profiler's device intervals) / wall."""


def read(record):
    prof = record["profile"]
    if not prof.get("busy_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
