"""Pluggable workload registry: every per-layer cost source the DAG
model can consume, resolvable by name from a :class:`Scenario`.

A copy of :mod:`repro.core.workloads` with the ``cnn:``, ``trace:`` and
``llm:`` providers (``llm:`` over the port's config registry) and
``torch:`` in place of the reference's ``jax:``.

The paper's point (§VI) is that the DAG model is agnostic to where the
per-layer costs come from — analytic layer tables (Table IV), measured
traces (Table VI), or any other profile.  This module makes that
pluggable: a *workload name* resolves through a scheme-prefixed
registry to a :class:`WorkloadTable`, the single construction path for
:class:`~repro_torch.core.dag.IterationCosts` shared by the sweep engine's
analytical fast path and the event-driven simulator.

Naming scheme (``scheme:spec``):

* ``cnn:<name>`` — the paper's Table-IV layer tables from
  :mod:`repro_torch.core.costmodel` (``alexnet``, ``googlenet``,
  ``resnet50``).  Bare names without a scheme resolve here for
  backward compatibility.
* ``trace:<name-or-path>`` — measured layer traces: the bundled
  Table VI (``trace:alexnet-k80``) or any on-disk file in the paper's
  trace format (``trace:path/to/file.trace``).  Compute times are the
  measured ones; comm is re-derived from the per-layer gradient bytes
  so traces sweep across worker counts / collectives / interconnects.
* ``llm:<arch>`` — per-block layer costs sliced out of
  :func:`repro_torch.core.archcost.block_cost_table` for every config in
  :mod:`repro_torch.configs` (``llm:gemma3-1b``, ``llm:qwen1.5-32b``, …),
  with bf16 gradient payloads and pattern-aware blocks, at the
  ``train_4k`` sequence length.
* ``torch:<name-or-path>`` — **measured** per-layer costs from the
  port's own executed S-SGD steps on the card (``python -m
  repro_torch.measure``, :mod:`repro_torch.measure`), the counterpart of
  the reference's ``jax:`` provider.  Resolves ``<arch>.trace`` files
  from the port's measurement directory (``REPRO_TORCH_MEASURE_DIR`` env
  var, default ``results/measure_torch/``, where ``python -m
  repro_torch.measure`` writes by default) by stem, or any explicit path.
  Same measured-table semantics as ``trace:`` — compute times are the
  measured ones, comm is re-derived from per-layer gradient bytes — so a
  model measured on the card sweeps across clusters, workers and
  collectives like any analytic table.

Tables are memoized at module scope (:func:`resolve_workload`), so
repeated ``sweep()`` / ``evaluate_scenario()`` calls never rebuild a
layer list.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.costmodel import CNN_WORKLOADS, total_params, update_time
from repro_torch.core.dag import IterationCosts
from repro_torch.core.hardware import ClusterSpec

#: Sequence length the ``llm:`` provider costs one "sample" at (one
#: sample = one sequence), matching the reference's ``TRAIN_4K`` shape.
LLM_SEQ_LEN = 4096

#: Bytes of input read/copied per LLM sample: int32 token ids.
LLM_BYTES_PER_TOKEN = 4.0


@dataclass(frozen=True, eq=False)
class WorkloadTable:
    """Per-workload layer arrays — built once, memoized, and shared.

    Exactly one compute-time source is set:

    * **analytic** (``flops_fwd`` is not ``None``): per-sample forward
      flops per layer; times derive from the cluster's achieved rate,
      backward = ``bwd_fwd_ratio`` × forward.
    * **measured** (``t_f``/``t_b`` are not ``None``): per-layer
      seconds measured at ``batch_default`` samples; times scale
      linearly with the requested batch.

    ``grad_bytes`` is always the per-layer all-reduce payload in bytes
    (f32 for CNN tables, bf16 for LLM configs, verbatim for traces),
    which is what lets every source sweep across worker counts,
    collectives and interconnects.
    """

    name: str
    grad_bytes: np.ndarray            # (L,) all-reduce payload per layer
    batch_default: int                # samples/GPU when the scenario says None
    bytes_per_sample: float           # input bytes read + copied per sample
    param_bytes: float                # total parameter bytes (for t_u)
    flops_fwd: np.ndarray | None = None   # (L,) per-sample fwd flops (analytic)
    t_f: np.ndarray | None = None         # (L,) measured fwd seconds @ batch_default
    t_b: np.ndarray | None = None         # (L,) measured bwd seconds @ batch_default
    t_io_measured: float | None = None    # measured input-pipeline seconds
    bwd_fwd_ratio: float = 2.0
    batch_locked: bool = False        # True: measured batch unknown, no rescale

    @property
    def num_layers(self) -> int:
        return len(self.grad_bytes)

    @property
    def is_measured(self) -> bool:
        return self.t_f is not None

    def iteration_costs(self, cluster: ClusterSpec, batch_per_gpu: int,
                        n_workers: int, collective: str = "ring",
                        bwd_fwd_ratio: float | None = None,
                        bytes_per_sample: float | None = None,
                        decode_seconds_per_byte: float = 0.0) -> IterationCosts:
        """The paper's Table-I cost vocabulary (seconds) on a concrete
        cluster — the one construction path used by both the analytical
        fast path and the simulator fallback, so the two cannot drift.

        ``bytes_per_sample`` overrides the table's own;
        ``bwd_fwd_ratio`` and ``decode_seconds_per_byte`` work exactly
        as in :func:`repro_torch.core.costmodel.make_iteration_costs` but
        apply to analytic tables only — a measured trace carries its
        own backward times and its input-pipeline time already
        includes the decode, so overriding either there is an error.

        All per-layer entries come back as NumPy float64 arrays; the
        closed forms in :mod:`repro_torch.core.analytical` evaluate them
        directly and the DAG builder iterates them as scalars.
        """
        if self.is_measured:
            if self.batch_locked and batch_per_gpu != self.batch_default:
                raise ValueError(
                    f"workload {self.name!r} has no recorded batch size "
                    f"(no '# batch:' header in the trace), so its measured "
                    f"times cannot be rescaled to batch_per_gpu="
                    f"{batch_per_gpu}; leave batch_per_gpu unset")
            if bwd_fwd_ratio is not None:
                raise ValueError(
                    f"bwd_fwd_ratio does not apply to measured workload "
                    f"{self.name!r}: the trace carries its own backward "
                    f"times")
            if decode_seconds_per_byte:
                raise ValueError(
                    f"decode_seconds_per_byte does not apply to measured "
                    f"workload {self.name!r}: the trace's input-pipeline "
                    f"time already includes the decode")
            scale = batch_per_gpu / self.batch_default
            t_f = self.t_f * scale
            t_b = self.t_b * scale
        else:
            ratio = self.bwd_fwd_ratio if bwd_fwd_ratio is None \
                else bwd_fwd_ratio
            t_f = cluster.compute_time(self.flops_fwd * batch_per_gpu)
            t_b = ratio * t_f
        if n_workers > 1:
            t_c = np.where(
                self.grad_bytes > 0,
                cluster.allreduce_time(self.grad_bytes, n_workers, collective),
                0.0)
        else:
            t_c = np.zeros_like(t_f)
        bps = self.bytes_per_sample if bytes_per_sample is None \
            else bytes_per_sample
        nbytes_in = batch_per_gpu * bps
        if self.t_io_measured is not None:
            t_io = self.t_io_measured * batch_per_gpu / self.batch_default
        else:
            t_io = cluster.io_time(nbytes_in) \
                + decode_seconds_per_byte * nbytes_in
        return IterationCosts(
            t_f=t_f, t_b=t_b, t_c=t_c,
            t_io=t_io,
            t_h2d=cluster.h2d_time(nbytes_in),
            t_u=update_time(self.param_bytes, cluster),
            grad_bytes=self.grad_bytes)


@runtime_checkable
class WorkloadProvider(Protocol):
    """One workload family: resolves ``spec`` (the part after the
    scheme prefix) to a :class:`WorkloadTable`."""

    scheme: str

    def names(self) -> tuple[str, ...]:
        """Enumerable specs (for error messages and docs); providers
        accepting open-ended specs (file paths) list their fixed ones."""
        ...

    def build(self, spec: str) -> WorkloadTable:
        """Build the table, raising ``ValueError`` for unknown specs."""
        ...


# ----------------------------------------------------------------------
# cnn: — the paper's Table-IV analytic layer tables.
# ----------------------------------------------------------------------
class CNNProvider:
    scheme = "cnn"

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(CNN_WORKLOADS))

    def build(self, spec: str) -> WorkloadTable:
        try:
            builder, batch, bytes_per_sample = CNN_WORKLOADS[spec]
        except KeyError:
            raise ValueError(f"unknown cnn workload {spec!r}; "
                             f"one of {sorted(CNN_WORKLOADS)}") from None
        layers = builder()
        return WorkloadTable(
            name=f"cnn:{spec}",
            flops_fwd=np.array([l.flops_fwd for l in layers], dtype=np.float64),
            grad_bytes=np.array([l.grad_bytes for l in layers], dtype=np.float64),
            batch_default=batch,
            bytes_per_sample=bytes_per_sample,
            param_bytes=4.0 * total_params(layers))


# ----------------------------------------------------------------------
# trace: — measured layer traces (bundled Table VI or on-disk files).
# ----------------------------------------------------------------------
class TraceProvider:
    scheme = "trace"

    #: Default on-disk bytes/sample when the trace doesn't say (ImageNet
    #: JPEG, the paper's Table IV figure — only feeds t_h2d since traces
    #: carry their own measured input-pipeline time).
    bytes_per_sample = 110e3

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._bundled()))

    @staticmethod
    def _bundled():
        from repro_torch.traces.bundled import BUNDLED_TRACES

        return BUNDLED_TRACES

    def build(self, spec: str) -> WorkloadTable:
        bundled = self._bundled()
        if spec in bundled:
            return self.table_from_trace(bundled[spec], f"trace:{spec}")
        if os.path.exists(spec):
            from repro_torch.traces.format import read_trace

            return self.table_from_trace(read_trace(spec), f"trace:{spec}")
        raise ValueError(f"unknown trace {spec!r}: not a bundled trace "
                         f"({sorted(bundled)}) and no such file")

    def cache_key(self, spec: str) -> str:
        """File-backed specs memoize by absolute path + mtime, so a
        chdir, an overwrite, or a different file at the same relative
        path never silently serves a stale table."""
        if spec not in self._bundled() and os.path.exists(spec):
            path = os.path.abspath(spec)
            return f"{path}@{os.stat(path).st_mtime_ns}"
        return spec

    def table_from_trace(self, trace, name: str) -> WorkloadTable:
        """Measured table: mean-iteration layer times in seconds, the
        Caffe ``data`` layer mapped to ``t_io``
        (:meth:`repro_torch.traces.format.Trace.mean_compute_records` owns
        that convention).  A trace without a ``# batch:`` header gets a
        locked nominal batch of 1: its measured times stay usable but
        cannot be rescaled to other batch sizes.  A trace with a
        ``# bytes-per-sample:`` header carries its own input-byte
        convention; otherwise the provider's default applies."""
        from repro_torch.traces.format import US

        recs, t_io = trace.mean_compute_records()
        grad_bytes = np.array([r.size_bytes for r in recs], dtype=np.float64)
        return WorkloadTable(
            name=name,
            grad_bytes=grad_bytes,
            batch_default=trace.batch_per_gpu or 1,
            bytes_per_sample=trace.bytes_per_sample or self.bytes_per_sample,
            param_bytes=float(grad_bytes.sum()),
            t_f=np.array([r.forward_us * US for r in recs], dtype=np.float64),
            t_b=np.array([r.backward_us * US for r in recs], dtype=np.float64),
            t_io_measured=t_io,
            batch_locked=not trace.batch_per_gpu)


# ----------------------------------------------------------------------
# torch: — measured traces from the port's own executed train steps
# (repro_torch.measure).
# ----------------------------------------------------------------------
class TorchProvider(TraceProvider):
    """Measured ``torch:`` workloads — the model<->measurement bridge.

    ``python -m repro_torch.measure --arch <id>`` runs real S-SGD steps on
    the card, segments per-unit forward/backward seconds and writes a
    paper-format ``<id>.trace`` into the measurement directory.  This
    provider resolves ``torch:<stem>`` against that directory (or
    ``torch:<path>`` for any explicit trace file), producing a *measured*
    :class:`WorkloadTable` exactly like ``trace:`` does — so a model
    measured on the card sweeps through the batched engine with no special
    casing downstream.
    """

    scheme = "torch"

    #: Fallback input bytes/sample when the trace lacks a
    #: ``# bytes-per-sample:`` header: int32 token ids + labels at the
    #: ``llm:`` provider's sequence length.  The harness always writes
    #: the header, so this only covers hand-made files.
    bytes_per_sample = 2 * LLM_BYTES_PER_TOKEN * LLM_SEQ_LEN

    @staticmethod
    def measure_dir() -> str:
        """Where measured traces live: ``$REPRO_TORCH_MEASURE_DIR`` or the
        repo-level ``results/measure_torch/``."""
        env = os.environ.get("REPRO_TORCH_MEASURE_DIR")
        if env:
            return env
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        return os.path.join(root, "results", "measure_torch")

    def names(self) -> tuple[str, ...]:
        d = self.measure_dir()
        if not os.path.isdir(d):
            return ()
        return tuple(sorted(
            f[:-len(".trace")] for f in os.listdir(d)
            if f.endswith(".trace")))

    def _resolve_path(self, spec: str) -> str | None:
        if os.path.exists(spec):
            return spec
        cached = os.path.join(self.measure_dir(), spec + ".trace")
        if os.path.exists(cached):
            return cached
        return None

    def build(self, spec: str) -> WorkloadTable:
        path = self._resolve_path(spec)
        if path is None:
            raise ValueError(
                f"no measured trace for {spec!r}: not a file and nothing "
                f"at {os.path.join(self.measure_dir(), spec + '.trace')!r} "
                f"(measured: {list(self.names())}); run "
                f"`python -m repro_torch.measure --arch <id>` to measure it")
        from repro_torch.traces.format import read_trace

        return self.table_from_trace(read_trace(path), f"torch:{spec}")

    def cache_key(self, spec: str) -> str:
        """Memoize by resolved absolute path + mtime (same contract as
        ``trace:`` file specs): re-measuring an arch or pointing
        ``REPRO_TORCH_MEASURE_DIR`` elsewhere never serves a stale table."""
        path = self._resolve_path(spec)
        if path is None:
            return spec
        path = os.path.abspath(path)
        return f"{path}@{os.stat(path).st_mtime_ns}"


# ----------------------------------------------------------------------
# llm: — per-block costs sliced from archcost for every assigned config.
# ----------------------------------------------------------------------
class LLMProvider:
    scheme = "llm"

    def names(self) -> tuple[str, ...]:
        from repro_torch.configs import ARCH_IDS

        return tuple(sorted(ARCH_IDS))

    def build(self, spec: str) -> WorkloadTable:
        from repro_torch.configs import get_config
        from repro_torch.core.archcost import block_cost_table

        try:
            cfg = get_config(spec)
        except KeyError as e:
            raise ValueError(str(e)) from None
        blocks = block_cost_table(cfg, LLM_SEQ_LEN)
        # bf16 gradient payloads over *total* params (every expert's
        # gradient is all-reduced, not just the routed-active ones);
        # compute from *active* params, matching archcost.step_cost.
        return WorkloadTable(
            name=f"llm:{spec}",
            flops_fwd=np.array([b.flops_fwd for b in blocks], dtype=np.float64),
            grad_bytes=np.array([2.0 * b.params for b in blocks],
                                dtype=np.float64),
            batch_default=1,
            bytes_per_sample=LLM_BYTES_PER_TOKEN * LLM_SEQ_LEN,
            param_bytes=2.0 * sum(b.params for b in blocks))


# ----------------------------------------------------------------------
# Registry + module-scope memoization.
# ----------------------------------------------------------------------
WORKLOAD_PROVIDERS: dict[str, WorkloadProvider] = {}

_TABLES: dict[str, WorkloadTable] = {}


def register_provider(provider: WorkloadProvider) -> None:
    WORKLOAD_PROVIDERS[provider.scheme] = provider


register_provider(CNNProvider())
register_provider(TraceProvider())
register_provider(LLMProvider())
register_provider(TorchProvider())


def canonical_name(workload: str) -> str:
    """Scheme-qualified form: bare Table-IV names become ``cnn:<name>``
    (backward compatibility with the pre-registry sweep engine)."""
    if ":" in workload:
        return workload
    return f"cnn:{workload}"


def resolve_workload(workload: str) -> WorkloadTable:
    """Workload name -> memoized :class:`WorkloadTable`.

    Raises ``ValueError`` with the known names for anything
    unresolvable — this is also what :meth:`Scenario.validate` calls.
    """
    scheme, _, spec = canonical_name(workload).partition(":")
    provider = WORKLOAD_PROVIDERS.get(scheme)
    if provider is None:
        raise ValueError(
            f"unknown workload {workload!r}: no provider for scheme "
            f"{scheme!r}; known workloads: {describe_workloads()}")
    # providers may refine the memoization key (e.g. the trace provider
    # keys file-backed specs by absolute path + mtime)
    key_fn = getattr(provider, "cache_key", None)
    key = f"{scheme}:{key_fn(spec) if key_fn else spec}"
    table = _TABLES.get(key)
    if table is None:
        try:
            table = provider.build(spec)
        except ValueError as e:
            raise ValueError(f"unknown workload {workload!r}: {e}") from None
        _TABLES[key] = table
    return table


def validate_workload(workload: str) -> None:
    """Raise ``ValueError`` unless ``workload`` resolves (memoized, so
    eager grid validation stays cheap)."""
    resolve_workload(workload)


def known_workloads() -> list[str]:
    """Every enumerable workload name, scheme-qualified and sorted."""
    return sorted(f"{scheme}:{spec}"
                  for scheme, p in WORKLOAD_PROVIDERS.items()
                  for spec in p.names())


def describe_workloads() -> str:
    """One-line summary of the registry for error messages / --help."""
    suffixes = {
        "trace": " or a trace-file path",
        "torch": " or a measured-trace path (python -m repro_torch.measure)",
    }
    parts = []
    for scheme in sorted(WORKLOAD_PROVIDERS):
        names = ", ".join(WORKLOAD_PROVIDERS[scheme].names())
        parts.append(f"{scheme}: [{names}]{suffixes.get(scheme, '')}")
    return "; ".join(parts)
