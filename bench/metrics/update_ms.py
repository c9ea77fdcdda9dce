"""Mean milliseconds a step of the traced window spends in the benchmark's
span around the optimizer's ``update``: SGD with momentum over every leaf;
each span is closed by a synchronize."""


def read(record):
    times = record["spans"].get("update")
    return 1e3 * sum(times) / len(times) if times else None
