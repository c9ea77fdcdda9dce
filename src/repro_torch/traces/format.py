"""The paper's layer-wise trace format (§VI): the writer.

A copy of ``repro.traces.format``'s :class:`LayerRecord`, :class:`Trace`
and :func:`write_trace` (without ``to_iteration_costs``, which needs the
DAG model), byte-compatible with ``repro.traces.format.read_trace``.
Each file holds iterations of records with six columns::

    Id  Name  Forward  Backward  Comm.  Size

times in **microseconds**, gradient ``Size`` in **bytes**.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class LayerRecord:
    layer_id: int
    name: str
    forward_us: float
    backward_us: float
    comm_us: float
    size_bytes: float


@dataclass(frozen=True)
class Trace:
    """One or more iterations of layer-wise records; every iteration
    must record the same layers.  ``batch_per_gpu`` and
    ``bytes_per_sample`` are written as headers (0 = unrecorded)."""

    network: str
    cluster: str
    iterations: tuple[tuple[LayerRecord, ...], ...]
    batch_per_gpu: int = 0
    bytes_per_sample: float = 0.0

    def __post_init__(self):
        if not self.iterations:
            raise ValueError("trace has no iterations")
        counts = {len(it) for it in self.iterations}
        if len(counts) > 1:
            raise ValueError(
                f"ragged trace: iterations record different layer counts "
                f"{sorted(counts)}; every iteration must have the same "
                f"layers")
        if 0 in counts:
            raise ValueError("trace iteration has no layer records")

    @property
    def num_layers(self) -> int:
        return len(self.iterations[0])


def write_trace(trace: Trace, path: str | Path) -> None:
    # %.17g is the shortest format that round-trips every float64
    # exactly, so write_trace -> read_trace is the identity.
    with open(path, "w") as f:
        f.write(f"# network: {trace.network}\n# cluster: {trace.cluster}\n")
        if trace.batch_per_gpu:
            f.write(f"# batch: {trace.batch_per_gpu}\n")
        if trace.bytes_per_sample:
            f.write(f"# bytes-per-sample: {trace.bytes_per_sample:.17g}\n")
        f.write("# Id\tName\tForward\tBackward\tComm.\tSize\n")
        for k, it in enumerate(trace.iterations):
            f.write(f"# iteration {k}\n")
            for r in it:
                f.write(f"{r.layer_id}\t{r.name}\t{r.forward_us:.17g}\t"
                        f"{r.backward_us:.17g}\t{r.comm_us:.17g}\t"
                        f"{r.size_bytes:.17g}\n")
