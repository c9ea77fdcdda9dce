"""The paper's layer-wise trace format (§VI).

A copy of ``repro.traces.format``'s :class:`LayerRecord`, :class:`Trace`
(with ``to_iteration_costs``, into the port's copy of the DAG model),
:func:`write_trace`, :func:`read_trace` and :func:`make_trace`; files it writes are
byte-identical to the reference's.  Each file holds iterations of records
with six columns::

    Id  Name  Forward  Backward  Comm.  Size

times in **microseconds**, gradient ``Size`` in **bytes**.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Sequence

from repro_torch.core.dag import IterationCosts

US = 1e-6


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

    def mean_iteration(self) -> tuple[LayerRecord, ...]:
        """Average each layer over iterations."""
        n = len(self.iterations)
        first = self.iterations[0]
        out = []
        for i, rec in enumerate(first):
            f = sum(it[i].forward_us for it in self.iterations) / n
            b = sum(it[i].backward_us for it in self.iterations) / n
            c = sum(it[i].comm_us for it in self.iterations) / n
            out.append(LayerRecord(rec.layer_id, rec.name, f, b, c,
                                   rec.size_bytes))
        return tuple(out)

    def mean_compute_records(self) -> tuple[tuple[LayerRecord, ...],
                                            float | None]:
        """``(compute_records, io_seconds)``: the mean iteration with the
        Caffe ``data`` layer split off as the input-pipeline time in
        **seconds** (``None`` when there is no data layer)."""
        recs = list(self.mean_iteration())
        io_time = None
        if recs and recs[0].name == "data":
            io_time = recs[0].forward_us * US
            recs = recs[1:]
        return tuple(recs), io_time

    def to_iteration_costs(self, t_io: float | None = None,
                           t_h2d: float = 0.0, t_u: float = 0.0,
                           data_layer_as_io: bool = True) -> IterationCosts:
        """Convert to seconds-based :class:`IterationCosts`; with
        ``data_layer_as_io`` the Caffe ``data`` layer becomes ``t_io``
        rather than a compute layer."""
        if data_layer_as_io:
            recs, io_measured = self.mean_compute_records()
            io_time = io_measured or 0.0
        else:
            recs, io_time = list(self.mean_iteration()), 0.0
        if t_io is not None:
            io_time = t_io
        return IterationCosts(
            t_f=[r.forward_us * US for r in recs],
            t_b=[r.backward_us * US for r in recs],
            t_c=[r.comm_us * US for r in recs],
            t_io=io_time,
            t_h2d=t_h2d,
            t_u=t_u,
            grad_bytes=[r.size_bytes for r in recs],
        )


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


def read_trace(path: str | Path, network: str = "", cluster: str = "") -> Trace:
    iterations: list[list[LayerRecord]] = []
    cur: list[LayerRecord] = []
    meta = {"network": network, "cluster": cluster}
    batch = 0
    bytes_per_sample = 0.0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                body = line.lstrip("# ").strip()
                if body.startswith("network:"):
                    meta["network"] = body.split(":", 1)[1].strip()
                elif body.startswith("cluster:"):
                    meta["cluster"] = body.split(":", 1)[1].strip()
                elif body.startswith("batch:"):
                    value = body.split(":", 1)[1].strip()
                    try:
                        batch = int(value)
                    except ValueError:
                        raise ValueError(
                            f"malformed trace file {path}: '# batch:' "
                            f"value {value!r} is not an integer") from None
                elif body.startswith("bytes-per-sample:"):
                    value = body.split(":", 1)[1].strip()
                    try:
                        bytes_per_sample = float(value)
                    except ValueError:
                        raise ValueError(
                            f"malformed trace file {path}: "
                            f"'# bytes-per-sample:' value {value!r} is not "
                            f"a number") from None
                elif body.startswith("iteration") and cur:
                    iterations.append(cur)
                    cur = []
                continue
            parts = line.split("\t") if "\t" in line else line.split()
            lid, name, fw, bw, cm, sz = parts[:6]
            rec = LayerRecord(int(lid), name, float(fw), float(bw),
                              float(cm), float(sz))
            if cur and rec.layer_id <= cur[-1].layer_id:
                iterations.append(cur)
                cur = []
            cur.append(rec)
    if cur:
        iterations.append(cur)
    if not iterations:
        raise ValueError(f"empty trace file: {path}")
    try:
        return Trace(meta["network"], meta["cluster"],
                     tuple(tuple(it) for it in iterations),
                     batch_per_gpu=batch, bytes_per_sample=bytes_per_sample)
    except ValueError as e:
        raise ValueError(f"malformed trace file {path}: {e}") from None


def make_trace(network: str, cluster: str, rows: Iterable[Sequence],
               n_copies: int = 1, batch_per_gpu: int = 0,
               bytes_per_sample: float = 0.0) -> Trace:
    """Build a Trace from ``(id, name, fwd_us, bwd_us, comm_us, size)`` rows."""
    recs = tuple(LayerRecord(int(r[0]), str(r[1]), float(r[2]), float(r[3]),
                             float(r[4]), float(r[5])) for r in rows)
    return Trace(network, cluster, tuple(recs for _ in range(n_copies)),
                 batch_per_gpu=batch_per_gpu,
                 bytes_per_sample=bytes_per_sample)
