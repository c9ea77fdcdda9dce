"""Mean milliseconds a step of the traced window spends in the benchmark's
span around ``next(loader)``: how long a step waits for its batch;
each span is closed by a synchronize."""


def read(record):
    times = record["spans"].get("data_wait")
    return 1e3 * sum(times) / len(times) if times else None
