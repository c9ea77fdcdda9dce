"""Declarative scenario grids for the S-SGD sweep engine.

A copy of :mod:`repro.core.scenarios`: :class:`Scenario`,
:class:`ScenarioGrid`, the ``default``, ``mixed`` and ``frontier`` grids
and :func:`grid_from_spec`.

A :class:`Scenario` is one fully-specified what-if question the paper's
DAG model can answer: *this* workload on *this* cluster with *this*
many workers, *this* interconnect, *this* overlap policy and *this*
all-reduce algorithm.  A :class:`ScenarioGrid` is the cross product of
axis values — the shape of study behind the paper's Figs. 2-4 (four
frameworks x two clusters x three CNNs x 1..16 GPUs) and of every
follow-up study §VII calls for.

:mod:`repro_torch.core.sweep` evaluates grids; this module only describes
and validates them, so grids stay cheap to build, hash and diff.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Iterator, Sequence

from repro_torch.core import het as het_mod
from repro_torch.core.hardware import (CLUSTERS, COLLECTIVE_ALGORITHMS,
                                       INTERCONNECT_PRESETS,
                                       resolve_interconnect_preset)
from repro_torch.core.policies import ALL_POLICIES
from repro_torch.core.workloads import validate_workload


def normalize_interconnect(interconnect: str | None) -> str:
    """The one spelling of "cluster default links" used everywhere:
    ``None`` and ``"default"`` both mean it, and rows/labels/filters all
    go through this normalizer so they can never disagree."""
    return "default" if interconnect is None else interconnect


def normalize_sync_k(sync_k: int | None) -> int:
    """The one spelling of "full synchronization" used everywhere:
    ``None``/``0``/``"none"`` all mean it and normalize to ``0``; a
    positive K means "sync with the first K of N gradients" (backup
    workers).  The effective threshold is clamped to the scenario's
    worker count at evaluation time
    (:func:`repro_torch.core.analytical.effective_sync_k`), which keeps
    grid-axis validation separable from the worker-count axis."""
    if sync_k is None or sync_k == "none" or sync_k == 0:
        return 0
    return int(sync_k)


def validate_sync_k(sync_k: int | None) -> None:
    """Raise ``ValueError`` unless ``sync_k`` is a full-sync sentinel
    (``None``/``0``/``"none"``) or a positive int."""
    if sync_k is None or sync_k == "none":
        return
    try:
        k = int(sync_k)
    except (TypeError, ValueError):
        raise ValueError(
            f"sync_k must be 'none' or a positive int, got {sync_k!r}"
        ) from None
    if k < 0:
        raise ValueError(f"sync_k must be >= 0 (0 = full sync), got {k}")


def validate_interconnect(interconnect: str | None) -> None:
    """Raise ``ValueError`` unless ``interconnect`` is ``None``,
    ``"default"``, a preset name, or a scaled preset
    (``<base>@bw<F>@lat<F>``)."""
    if interconnect is None or interconnect == "default":
        return
    try:
        resolve_interconnect_preset(interconnect)
    except (KeyError, ValueError) as e:
        raise ValueError(
            f"unknown interconnect preset {interconnect!r}: {e}; one of "
            f"{sorted(INTERCONNECT_PRESETS)} (optionally with @bw<F>/"
            f"@lat<F> modifiers) or None") from None


@dataclass(frozen=True)
class Scenario:
    """One point of the sweep: a fully-resolved what-if question.

    ``workload`` is any name the workload registry resolves
    (:func:`repro_torch.core.workloads.resolve_workload`): a bare Table-IV
    CNN name, ``cnn:<name>``, ``trace:<bundled-or-path>`` or
    ``llm:<arch>``.  ``interconnect`` is ``None`` (cluster default) or
    a preset name from
    :data:`repro_torch.core.hardware.INTERCONNECT_PRESETS`; ``batch_per_gpu``
    ``None`` means the workload's default (Table IV for CNNs, the
    measured batch for traces, one sequence for LLM configs).
    """

    workload: str
    cluster: str
    n_workers: int
    policy: str
    collective: str = "ring"
    interconnect: str | None = None
    het: str | None = None
    straggler: str | None = None
    sync_k: int | None = None
    faults: str | None = None
    batch_per_gpu: int | None = None

    def label(self) -> str:
        ic = normalize_interconnect(self.interconnect)
        label = (f"{self.workload}/{self.cluster}/w{self.n_workers}"
                 f"/{self.policy}/{self.collective}/{ic}")
        if self.het is not None and self.het != "none":
            label += f"/{self.het}"
        if self.straggler is not None and self.straggler != "none":
            label += f"/{self.straggler}"
        if normalize_sync_k(self.sync_k):
            label += f"/k{normalize_sync_k(self.sync_k)}"
        if self.faults is not None and self.faults != "none":
            label += f"/{self.faults}"
        return label

    def validate(self) -> None:
        validate_workload(self.workload)     # any registered provider
        if self.cluster not in CLUSTERS:
            raise ValueError(f"unknown cluster {self.cluster!r}; "
                             f"one of {sorted(CLUSTERS)}")
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {self.n_workers}")
        if self.policy not in ALL_POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; "
                             f"one of {sorted(ALL_POLICIES)}")
        if self.collective not in COLLECTIVE_ALGORITHMS:
            raise ValueError(f"unknown collective {self.collective!r}; "
                             f"one of {COLLECTIVE_ALGORITHMS}")
        validate_interconnect(self.interconnect)
        try:
            het_mod.validate_het(self.het)
            het_mod.validate_straggler(self.straggler)
            het_mod.validate_fault(self.faults)
            validate_sync_k(self.sync_k)
        except ValueError as e:
            raise ValueError(str(e)) from None
        if self.batch_per_gpu is not None and self.batch_per_gpu < 1:
            raise ValueError(f"batch_per_gpu must be >= 1, "
                             f"got {self.batch_per_gpu}")


@dataclass(frozen=True)
class ScenarioGrid:
    """Cross product of sweep axes; ``expand()`` yields the scenarios.

    Every axis value is validated eagerly at expansion so a typo'd
    policy name fails before the first evaluation, not after thousands.
    """

    workloads: Sequence[str] = ("alexnet", "googlenet", "resnet50")
    clusters: Sequence[str] = ("k80-pcie-10gbe", "v100-nvlink-ib")
    worker_counts: Sequence[int] = (1, 2, 4, 8, 16)
    policies: Sequence[str] = ("naive", "cntk", "mxnet", "tensorflow",
                               "caffe-mpi")
    collectives: Sequence[str] = ("ring",)
    interconnects: Sequence[str | None] = (None,)
    het_profiles: Sequence[str | None] = (None,)
    stragglers: Sequence[str | None] = (None,)
    sync_ks: Sequence[int | None] = (None,)
    faults: Sequence[str | None] = (None,)
    batch_per_gpu: int | None = None

    def __len__(self) -> int:
        return (len(self.workloads) * len(self.clusters)
                * len(self.worker_counts) * len(self.policies)
                * len(self.collectives) * len(self.interconnects)
                * len(self.het_profiles) * len(self.stragglers)
                * len(self.sync_ks) * len(self.faults))

    def __iter__(self) -> Iterator[Scenario]:
        return iter(self.expand())

    def validate_axes(self) -> None:
        """Validate every axis *value* once.  Scenario validity is
        axis-separable (no cross-field constraints), so this is
        equivalent to validating all ``len(self)`` scenarios — which is
        exactly why ``expand()`` can skip per-scenario validation."""
        if self.batch_per_gpu is not None and self.batch_per_gpu < 1:
            raise ValueError(f"batch_per_gpu must be >= 1, "
                             f"got {self.batch_per_gpu}")
        for wl in self.workloads:
            validate_workload(wl)
        for cl in self.clusters:
            if cl not in CLUSTERS:
                raise ValueError(f"unknown cluster {cl!r}; "
                                 f"one of {sorted(CLUSTERS)}")
        for n in self.worker_counts:
            if int(n) < 1:
                raise ValueError(f"n_workers must be >= 1, got {n}")
        for pol in self.policies:
            if pol not in ALL_POLICIES:
                raise ValueError(f"unknown policy {pol!r}; "
                                 f"one of {sorted(ALL_POLICIES)}")
        for coll in self.collectives:
            if coll not in COLLECTIVE_ALGORITHMS:
                raise ValueError(f"unknown collective {coll!r}; "
                                 f"one of {COLLECTIVE_ALGORITHMS}")
        for ic in self.interconnects:
            validate_interconnect(ic)
        for h in self.het_profiles:
            het_mod.validate_het(h)
        for st in self.stragglers:
            het_mod.validate_straggler(st)
        for k in self.sync_ks:
            validate_sync_k(k)
        for f in self.faults:
            het_mod.validate_fault(f)

    def expand(self) -> list[Scenario]:
        self.validate_axes()
        return [Scenario(workload=wl, cluster=cl, n_workers=int(n),
                         policy=pol, collective=coll, interconnect=ic,
                         het=h, straggler=st, sync_k=sk, faults=fl,
                         batch_per_gpu=self.batch_per_gpu)
                for wl, cl, n, pol, coll, ic, h, st, sk, fl
                in itertools.product(
                    self.workloads, self.clusters, self.worker_counts,
                    self.policies, self.collectives, self.interconnects,
                    self.het_profiles, self.stragglers, self.sync_ks,
                    self.faults)]


def default_grid() -> ScenarioGrid:
    """The out-of-the-box study: every paper workload and cluster, six
    cluster sizes, the five exactly-solvable policies, and all three
    collective algorithms — 540 scenarios, all on the analytical fast
    path."""
    return ScenarioGrid(
        worker_counts=(1, 2, 4, 8, 16, 32),
        collectives=COLLECTIVE_ALGORITHMS,
    )


def mixed_grid() -> ScenarioGrid:
    """A cross-provider study on the same closed-form fast path: one
    Table-IV CNN, the bundled Table-VI measured trace, and three
    modern LLM configs (dense / MoE / recurrent), over both paper
    clusters and the TPU pod, six sizes, five exact policies and all
    three collectives — 1620 scenarios."""
    return ScenarioGrid(
        workloads=("cnn:resnet50", "trace:alexnet-k80",
                   "llm:gemma3-1b", "llm:qwen2-moe-a2.7b",
                   "llm:recurrentgemma-2b", "llm:qwen1.5-32b"),
        clusters=("k80-pcie-10gbe", "v100-nvlink-ib", "tpu-v5e-pod"),
        worker_counts=(1, 2, 4, 8, 16, 32),
        collectives=COLLECTIVE_ALGORITHMS,
    )


#: Frontier-grid what-if axes: inter-node link bases (``ib-100g-fused``
#: is the DDP-style bucket-fusion what-if — the collective efficiency a
#: fused gradient stream achieves, on the exact fast path) crossed with
#: bandwidth and latency scale factors via the scaled-preset grammar.
FRONTIER_LINK_BASES = ("10gbe", "ib-100g", "ib-100g-fused", "ib-200g")
FRONTIER_BW_FACTORS = (0.5, 1, 2, 4)
FRONTIER_LAT_FACTORS = (0.25, 1, 4)

#: Frontier policy axis: the five per-layer-exact policies plus the
#: schedule-dependent ones the bucket-timeline kernel made sweepable —
#: the bucket-size axis (1/4/25/100 MB) and priority scheduling.
FRONTIER_POLICIES = ("naive", "cntk", "mxnet", "tensorflow", "caffe-mpi",
                     "bucketed-1mb", "bucketed-4mb", "bucketed-25mb",
                     "bucketed-100mb", "priority")


#: Named base grids a declarative spec (or the CLI's ``--grid`` flag)
#: starts from — populated after the factory definitions below.
BASE_GRIDS: dict = {}

#: Axis keys :func:`grid_from_spec` understands besides ``"grid"`` —
#: the wire vocabulary shared by the sweep CLI's flags and the sweep
#: service's query documents.
GRID_SPEC_KEYS = ("workloads", "clusters", "workers", "policies",
                  "collectives", "interconnects", "het", "stragglers",
                  "sync_k", "faults", "batch_per_gpu")


def _spec_values(value, key: str) -> list:
    """Axis values from a spec entry: a JSON list or a comma-separated
    string (the CLI's flag format), never empty — an empty axis would
    make a zero-scenario grid, which no caller ever means."""
    if isinstance(value, str):
        vals = [t.strip() for t in value.split(",") if t.strip()]
    elif isinstance(value, (list, tuple)):
        vals = list(value)
    else:
        raise ValueError(
            f"{key} must be a list or a comma-separated string, "
            f"got {value!r}")
    if not vals:
        raise ValueError(f"{key} must have at least one value "
                         f"(an empty axis makes a zero-scenario grid)")
    return vals


def _spec_synck(k):
    validate_sync_k(k)
    return None if k in (None, "none", 0, "0") else int(k)


def grid_from_spec(spec: dict) -> ScenarioGrid:
    """A validated :class:`ScenarioGrid` from a declarative spec dict —
    the parser behind the sweep CLI's axis flags
    (:func:`repro_torch.sweep.grid_from_args`), as in the reference, where
    it also parses the sweep service's JSON query documents.

    Keys: ``"grid"`` names a base grid (:data:`BASE_GRIDS`, default
    ``"default"``); each :data:`GRID_SPEC_KEYS` entry overrides one
    axis (values: JSON lists or comma-separated strings).  ``"none"``
    spells the null value on the nullable axes (het / stragglers /
    sync_k / faults), ``"default"`` the cluster-default interconnect.
    Unknown keys and invalid axis values raise ``ValueError`` naming
    the alternatives; the returned grid has passed ``validate_axes()``.
    """
    if not isinstance(spec, dict):
        raise ValueError(f"grid spec must be a mapping (JSON object), "
                         f"got {type(spec).__name__}")
    unknown = set(spec) - set(GRID_SPEC_KEYS) - {"grid"}
    if unknown:
        raise ValueError(
            f"unknown grid-spec keys {sorted(unknown)}; known keys: "
            f"grid, {', '.join(GRID_SPEC_KEYS)}")
    name = spec.get("grid", "default")
    base_fn = BASE_GRIDS.get(name) if isinstance(name, str) else None
    if base_fn is None:
        raise ValueError(f"unknown base grid {name!r}; "
                         f"one of {sorted(BASE_GRIDS)}")
    axes: dict = {}
    for key, axis, conv in (
            ("workloads", "workloads", str),
            ("clusters", "clusters", str),
            ("workers", "worker_counts", int),
            ("policies", "policies", str),
            ("collectives", "collectives", str),
            ("interconnects", "interconnects",
             lambda i: None if i in (None, "default") else str(i)),
            ("het", "het_profiles",
             lambda h: None if h in (None, "none") else str(h)),
            ("stragglers", "stragglers",
             lambda s: None if s in (None, "none") else str(s)),
            ("sync_k", "sync_ks", _spec_synck),
            ("faults", "faults",
             lambda f: None if f in (None, "none") else str(f))):
        if spec.get(key) is None:
            continue
        try:
            axes[axis] = tuple(conv(v) for v in _spec_values(spec[key], key))
        except ValueError as e:
            raise ValueError(f"bad {key} value: {e}") from None
    if spec.get("batch_per_gpu") is not None:
        try:
            axes["batch_per_gpu"] = int(spec["batch_per_gpu"])
        except (TypeError, ValueError):
            raise ValueError(f"batch_per_gpu must be an integer, "
                             f"got {spec['batch_per_gpu']!r}") from None
    grid = dataclasses.replace(base_fn(), **axes)
    grid.validate_axes()
    return grid


def frontier_grid() -> ScenarioGrid:
    """The §VII design-space study at interactive scale: every paper CNN
    on both paper clusters, six cluster sizes, all three collectives,
    ten policies — the five exact ones **plus** the bucket-size axis
    (1/4/25/100 MB gradient fusion) and priority comm, both on the
    batched bucket-timeline path — and a ``bandwidth x latency x
    bucket-fusion`` interconnect frontier (four inter-node link bases,
    each at {0.5,1,2,4}x bandwidth and {0.25,1,4}x latency via the
    scaled-preset grammar) — 51 840 scenarios, every one batched.
    This is exactly the what-if study the paper's future-work section
    asks for (which bucket size rescues InfiniBand utilization, and at
    what link speed does fusion stop mattering?); the batched evaluator
    answers it in tens of milliseconds."""
    interconnects = tuple(
        f"{base}@bw{bw:g}@lat{lat:g}"
        for base in FRONTIER_LINK_BASES
        for bw in FRONTIER_BW_FACTORS
        for lat in FRONTIER_LAT_FACTORS)
    return ScenarioGrid(
        worker_counts=(2, 4, 8, 16, 32, 64),
        policies=FRONTIER_POLICIES,
        collectives=COLLECTIVE_ALGORITHMS,
        interconnects=interconnects,
    )


BASE_GRIDS.update(default=default_grid, mixed=mixed_grid,
                  frontier=frontier_grid)
