"""The paper's layer-wise trace of a run recorded by :mod:`repro_torch.tracing`.

One :class:`~repro_torch.traces.format.LayerRecord` each for the embedding,
every unit and the head with the loss: ``Forward`` and ``Backward`` from
the model boundaries' segments (``fwd.embed`` / ``fwd.unit`` / ``fwd.head``
and their ``bwd`` twins) on the device's clock, ``Size`` each layer's
gradient bytes, ``Comm.`` 0 (one rank).  A run keeps only
:func:`layer_times` of each step, given as the recorder's ``on_step``::

    steps = []
    with tracing.record(device, on_step=lambda _, spans: steps.append(layer_times(spans))) as rec:
        ...
    rec.summary()
    trace = paper_trace(steps, params, network, cluster)
"""
from __future__ import annotations

from repro_torch.models.transformer import leaf_order
from repro_torch.traces.format import LayerRecord, Trace

#: the segments of ``fwd`` and ``bwd`` that are layers
_LAYERS = ("embed", "unit", "head")


def layer_bytes(params) -> list[tuple[str, float]]:
    """(name, gradient bytes) of the traced layers: the embedding, each
    unit's slice of the stacked leaves, and the head with everything else
    (final norm, untied head, remainder blocks)."""
    emb = unit = rest = 0.0
    n = 0
    for path, leaf in leaf_order(params):
        nbytes = float(leaf.numel() * leaf.element_size())
        if path[0] == "embedding":
            emb += nbytes
        elif path[0] == "units":
            n = leaf.shape[0]
            unit += nbytes
        else:
            rest += nbytes
    units = [(f"unit{u}", unit / n) for u in range(n)]
    return [("embed", emb), *units, ("head", rest)]


def layer_times(spans: list[dict]) -> dict[tuple[str, str], float]:
    """(``fwd`` or ``bwd``, layer name) -> microseconds of one resolved
    step's spans; empty for a step that did not go through the model's
    boundaries."""
    times: dict[tuple[str, str], float] = {}
    for s in spans:
        way, _, kind = s["name"].partition(".")
        if way in ("fwd", "bwd") and kind in _LAYERS:
            name = f"unit{s['unit']}" if kind == "unit" else kind
            times[way, name] = times.get((way, name), 0.0) + (s["end_ms"] - s["start_ms"]) * 1e3
    return times


def paper_trace(steps: list[dict], params, network: str, cluster: str,
                batch_per_gpu: int = 0, bytes_per_sample: float = 0.0) -> Trace:
    """The trace of ``steps`` (:func:`layer_times` of each), an iteration a
    step that went through the model's boundaries; sizes from
    :func:`layer_bytes` of ``params``."""
    layers = layer_bytes(params)
    iterations = tuple(
        tuple(LayerRecord(i, name, times.get(("fwd", name), 0.0),
                          times.get(("bwd", name), 0.0), 0.0, nbytes)
              for i, (name, nbytes) in enumerate(layers))
        for times in steps if times)
    if not iterations:
        raise ValueError("no recorded step went through the model's boundaries")
    return Trace(network, cluster, iterations, batch_per_gpu=batch_per_gpu,
                 bytes_per_sample=bytes_per_sample)
