"""Mean milliseconds a step of the traced window spends in the benchmark's
span around the program's ``loss_and_grads``: forward, loss and backward;
each span is closed by a synchronize."""


def read(record):
    times = record["spans"].get("fwd_bwd")
    return 1e3 * sum(times) / len(times) if times else None
