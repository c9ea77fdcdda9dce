"""Per-worker heterogeneity: profiles, padded worker tables, stragglers.

A copy of :mod:`repro.core.het` (pure NumPy): the straggler and fault
draws come from the same keyed generators, so the port's sweeps see the
reference's samples draw for draw.

The paper's DAG model (§III) assumes all ``N`` workers are identical;
this module is the vocabulary that relaxes that.  A **heterogeneity
profile** assigns every worker a compute-speed multiplier and per-link
bandwidth/latency multipliers via a compact grammar on the scenario
axes (mirroring the scaled-interconnect grammar
``ib-100g@bw2@lat0.25``):

    het:<count>x<speed>[@bw<F>][@lat<F>][+<count>x<speed>...]

e.g. ``het:8x0.5+8x1.0`` — eight half-speed workers plus eight
full-speed ones; ``het:4x1@bw0.5`` — four workers whose links run at
half bandwidth.  Profiles are *ratio patterns*: a profile with ``C``
slots stretches to any ``n_workers`` by the proportional slot rule
``slot(i) = floor(i * C / n)``, which keeps grid-axis validation
separable from the worker-count axis.

A **straggler spec** adds stochastic per-worker compute jitter on top:

    <dist>:<scale>[x<draws>]        dist in {lognormal, exp}

``lognormal:0.2x1000`` multiplies every worker's compute time by
``exp(0.2 * Z)`` (``Z`` standard normal) in each of 1000 Monte Carlo
draws; ``exp:0.5`` uses ``1 + Exponential(0.5)`` multipliers (jitter
can only slow a worker down).  Draws are generated once in host NumPy
from a counter-based key — ``(spec, n_workers, seed)`` — so every
backend, process shard and chunk boundary sees the identical sample.

The synchronous steady state is gated by the *slowest* participant:
with per-worker multipliers constant across layers, the same worker
attains the per-layer max everywhere, so the heterogeneous iteration
time equals the homogeneous closed form evaluated at the bottleneck
multipliers ``tmul = max_w(jitter_w / speed_w)``,
``bwmul = min_w(bw_w)``, ``latmul = max_w(lat_w)`` (the reduction
:func:`repro_torch.core.analytical.worker_bottleneck` — validated ≤1e-6
against the per-worker event-driven simulator).  The padded
``(profile, W)`` tables here use *neutral* pads for those reductions:
``inv_speed = 0`` and ``lat_mult = 0`` (max-reduce), ``bw_mult = +inf``
(min-reduce) — padding with 1.0 would corrupt the max/min.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Sequence

import numpy as np

HET_PREFIX = "het:"
FAULT_PREFIX = "fail:"
STRAGGLER_DISTRIBUTIONS = ("lognormal", "exp")
DEFAULT_DRAWS = 1000
MAX_DRAWS = 1_000_000
#: Default checkpoint-restore penalty (seconds) when ``@restart<T>`` is
#: omitted from a fault spec: the wall-clock of re-reading a ~10 GB npz
#: checkpoint (:mod:`repro.checkpoint.ckpt` save/restore pair) from a
#: ~2 GB/s shared store and re-staging it — see :func:`restart_penalty_s`.
DEFAULT_RESTART_S = 5.0


def restart_penalty_s(ckpt_bytes: float, store_bw: float = 2e9) -> float:
    """Checkpoint-restore penalty for a checkpoint of ``ckpt_bytes``
    read from shared storage at ``store_bw`` bytes/s — the
    :mod:`repro.checkpoint.ckpt`-shaped cost a crashed worker pays
    before rejoining (npz read is bandwidth-bound; the h2d restage is
    folded into the same stream).  Use this to derive the
    ``@restart<T>`` value of a fault spec from a real model size."""
    if not ckpt_bytes >= 0:
        raise ValueError("ckpt_bytes must be >= 0")
    if not store_bw > 0:
        raise ValueError("store_bw must be > 0")
    return float(ckpt_bytes) / float(store_bw)


def normalize_het(spec: str | None) -> str:
    """The one spelling of "homogeneous workers" used everywhere:
    ``None`` and ``"none"`` both mean it (mirroring
    :func:`repro_torch.core.scenarios.normalize_interconnect`)."""
    return "none" if spec is None or spec == "none" else spec


def normalize_straggler(spec: str | None) -> str:
    """``None`` and ``"none"`` both mean "no jitter"."""
    return "none" if spec is None or spec == "none" else spec


@dataclass(frozen=True)
class HetSlot:
    """One homogeneous group inside a profile: ``count`` workers at
    compute-speed multiplier ``speed`` whose links run at
    ``bw_mult`` x bandwidth and ``lat_mult`` x latency."""

    count: int
    speed: float
    bw_mult: float = 1.0
    lat_mult: float = 1.0


@dataclass(frozen=True)
class HetProfile:
    """A parsed heterogeneity profile — an ordered tuple of slots."""

    slots: tuple[HetSlot, ...]

    @property
    def n_slots(self) -> int:
        return sum(s.count for s in self.slots)

    def slot_vectors(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-slot ``(inv_speed, bw_mult, lat_mult)`` vectors of
        length :attr:`n_slots` (slot counts expanded)."""
        inv = np.concatenate(
            [np.full(s.count, 1.0 / s.speed) for s in self.slots])
        bw = np.concatenate(
            [np.full(s.count, s.bw_mult) for s in self.slots])
        lat = np.concatenate(
            [np.full(s.count, s.lat_mult) for s in self.slots])
        return inv, bw, lat


def _parse_slot(part: str, spec: str) -> HetSlot:
    head, sep, mods = part.partition("@")
    if sep and not mods:
        raise ValueError(
            f"malformed het slot {part!r} in {spec!r}: dangling '@'")
    count_s, sep, speed_s = head.partition("x")
    if not sep:
        raise ValueError(
            f"malformed het slot {part!r} in {spec!r}: expected "
            f"<count>x<speed>[@bw<F>][@lat<F>]")
    try:
        count = int(count_s)
        speed = float(speed_s)
    except ValueError:
        raise ValueError(
            f"malformed het slot {part!r} in {spec!r}: count must be an "
            f"int and speed a float") from None
    if count < 1:
        raise ValueError(f"het slot count must be >= 1 in {spec!r}")
    if not speed > 0:
        raise ValueError(f"het slot speed must be > 0 in {spec!r}")
    bw_mult = lat_mult = 1.0
    if mods:
        for mod in mods.split("@"):
            if mod.startswith("bw"):
                key, val_s = "bw", mod[2:]
            elif mod.startswith("lat"):
                key, val_s = "lat", mod[3:]
            else:
                raise ValueError(
                    f"malformed het modifier {mod!r} in {spec!r}: "
                    f"expected bw<F> or lat<F>")
            try:
                val = float(val_s)
            except ValueError:
                raise ValueError(
                    f"malformed het modifier {mod!r} in {spec!r}") from None
            if not val > 0:
                raise ValueError(
                    f"het modifier {mod!r} in {spec!r} must be > 0")
            if key == "bw":
                bw_mult = val
            else:
                lat_mult = val
    return HetSlot(count=count, speed=speed,
                   bw_mult=bw_mult, lat_mult=lat_mult)


def parse_het_profile(spec: str | None) -> HetProfile | None:
    """Parse a heterogeneity spec; ``None``/``"none"`` -> ``None``
    (homogeneous).  Raises ``ValueError`` with the grammar on any
    malformed spec."""
    if spec is None or spec == "none":
        return None
    if not isinstance(spec, str) or not spec.startswith(HET_PREFIX):
        raise ValueError(
            f"unknown het profile {spec!r}: expected 'none' or "
            f"'het:<count>x<speed>[@bw<F>][@lat<F>][+...]'")
    body = spec[len(HET_PREFIX):]
    if not body:
        raise ValueError(f"empty het profile {spec!r}")
    return HetProfile(tuple(_parse_slot(p, spec) for p in body.split("+")))


def validate_het(spec: str | None) -> None:
    """Raise ``ValueError`` unless ``spec`` parses (axis validation)."""
    parse_het_profile(spec)


def worker_vectors(profile: HetProfile | None,
                   n_workers: int) -> tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    """Per-worker ``(inv_speed, bw_mult, lat_mult)`` vectors of length
    ``n_workers``: the profile's slot pattern stretched proportionally
    (worker ``i`` takes slot ``floor(i * n_slots / n_workers)``), so
    ``het:1x0.5+1x1.0`` means "the first half of the cluster is slow"
    at any size.  ``profile=None`` -> all-ones (homogeneous)."""
    n = int(n_workers)
    if profile is None:
        ones = np.ones(n)
        return ones, ones.copy(), ones.copy()
    inv, bw, lat = profile.slot_vectors()
    idx = (np.arange(n) * profile.n_slots) // n
    return inv[idx], bw[idx], lat[idx]


def worker_table_rows(pairs: Sequence[tuple[HetProfile | None, int]],
                      ) -> dict[str, np.ndarray]:
    """Padded per-worker tables for a list of ``(profile, n_workers)``
    pairs: ``(len(pairs), Wmax)`` float64 arrays ``inv_speed`` /
    ``bw_mult`` / ``lat_mult`` plus the integer ``n`` column.  Pads are
    *neutral* for :func:`repro_torch.core.analytical.worker_bottleneck`
    (``0`` for the max-reduced columns, ``+inf`` for the min-reduced
    bandwidth column), so reducing a padded row equals reducing the
    live prefix."""
    ns = np.array([int(n) for _, n in pairs], dtype=np.int64)
    wmax = int(ns.max()) if len(ns) else 1
    rows = len(pairs)
    inv = np.zeros((rows, wmax))
    bw = np.full((rows, wmax), np.inf)
    lat = np.zeros((rows, wmax))
    for j, (prof, n) in enumerate(pairs):
        iv, bv, lv = worker_vectors(prof, n)
        inv[j, :n], bw[j, :n], lat[j, :n] = iv, bv, lv
    return {"inv_speed": inv, "bw_mult": bw, "lat_mult": lat, "n": ns}


@dataclass(frozen=True)
class StragglerSpec:
    """A parsed straggler distribution: per-worker compute-jitter
    multipliers sampled per Monte Carlo draw."""

    dist: str          # "lognormal" | "exp"
    scale: float       # sigma (lognormal) / mean excess (exp), >= 0
    draws: int         # Monte Carlo draws

    @property
    def is_deterministic(self) -> bool:
        """``scale == 0`` short-circuits to the deterministic makespan
        (every multiplier is exactly 1.0; skipping the draws keeps the
        tail columns bit-identical to ``iteration_time_s`` instead of
        within one ulp of it)."""
        return self.scale == 0.0

    def key(self, n_workers: int) -> str:
        return f"{self.dist}:{self.scale:g}x{self.draws}|w{int(n_workers)}"

    def draw_matrix(self, n_workers: int, seed: int = 0) -> np.ndarray:
        """The ``(draws, n_workers)`` jitter-multiplier matrix.  Keyed
        by ``(spec, n_workers, seed)`` only — independent of chunk
        boundaries, process sharding and backend, so every evaluation
        path consumes the identical sample (draw-for-draw)."""
        rng = np.random.default_rng(
            [int(seed) & 0x7FFFFFFFFFFFFFFF,
             zlib.crc32(self.key(n_workers).encode())])
        shape = (self.draws, int(n_workers))
        if self.dist == "lognormal":
            return np.exp(self.scale * rng.standard_normal(shape))
        return 1.0 + rng.exponential(self.scale, shape)


def parse_straggler(spec: str | None) -> StragglerSpec | None:
    """Parse a straggler spec ``<dist>:<scale>[x<draws>]``;
    ``None``/``"none"`` -> ``None`` (no jitter)."""
    if spec is None or spec == "none":
        return None
    if not isinstance(spec, str):
        raise ValueError(f"unknown straggler spec {spec!r}")
    dist, sep, rest = spec.partition(":")
    if not sep or dist not in STRAGGLER_DISTRIBUTIONS:
        raise ValueError(
            f"unknown straggler spec {spec!r}: expected "
            f"'<dist>:<scale>[x<draws>]' with dist in "
            f"{STRAGGLER_DISTRIBUTIONS}")
    scale_s, sep, draws_s = rest.partition("x")
    try:
        scale = float(scale_s)
        draws = int(draws_s) if sep else DEFAULT_DRAWS
    except ValueError:
        raise ValueError(
            f"malformed straggler spec {spec!r}: scale must be a float "
            f"and draws an int") from None
    if scale < 0:
        raise ValueError(f"straggler scale must be >= 0 in {spec!r}")
    if not 1 <= draws <= MAX_DRAWS:
        raise ValueError(
            f"straggler draws must be in [1, {MAX_DRAWS}] in {spec!r}")
    return StragglerSpec(dist=dist, scale=scale, draws=draws)


def validate_straggler(spec: str | None) -> None:
    """Raise ``ValueError`` unless ``spec`` parses (axis validation)."""
    parse_straggler(spec)


def normalize_fault(spec: str | None) -> str:
    """``None`` and ``"none"`` both mean "no faults"."""
    return "none" if spec is None or spec == "none" else spec


@dataclass(frozen=True)
class FaultSpec:
    """A parsed fault-injection spec: per-iteration, per-worker crash
    probability plus the checkpoint-restore penalty a crash costs.

    The model is additive on the update chain: restores read the
    shared checkpoint store (:func:`restart_penalty_s`), which
    serializes them, and the synchronous update cannot broadcast until
    every crashed worker has rejoined — so an iteration with ``c``
    crashes (out of ``n`` per-worker Bernoulli(``p``) trials) extends
    the GPU/update chain by exactly ``c * restart``, independent of
    the ``sync_k`` threshold (even backup workers beyond the K-th
    gradient must re-join from the checkpoint before the next
    iteration).  The penalty rides *inside* the pipeline max, so an
    I/O-bound pipeline absorbs part of it.  The event-driven oracle
    reproduces this with explicit crash/restore tasks (see
    :class:`repro.core.dag.SSGDDagBuilder`)."""

    p: float           # per-iteration per-worker crash probability
    restart: float     # checkpoint-restore penalty in seconds, >= 0
    draws: int         # Monte Carlo draws (when no straggler spec rules)

    @property
    def is_deterministic(self) -> bool:
        """``p == 0`` or ``restart == 0`` means no draw can ever add a
        penalty — skip the Monte Carlo pass and keep the tail columns
        bit-identical to ``iteration_time_s``."""
        return self.p == 0.0 or self.restart == 0.0

    def key(self, n_workers: int, draws: int | None = None) -> str:
        d = self.draws if draws is None else int(draws)
        return (f"fail:{self.p:g}@restart{self.restart:g}x{d}"
                f"|w{int(n_workers)}")

    def crash_matrix(self, n_workers: int, seed: int = 0,
                     draws: int | None = None) -> np.ndarray:
        """The ``(draws, n_workers)`` boolean crash matrix — entry
        ``[d, w]`` is True when worker ``w`` crashes in draw ``d``.
        Keyed by ``(spec, effective draws, n_workers, seed)`` only, like
        :meth:`StragglerSpec.draw_matrix`, so every backend, shard and
        chunk consumes the identical sample.  ``draws`` overrides the
        spec's own count when a straggler spec sets the Monte Carlo
        draw count for the combined pass."""
        d = self.draws if draws is None else int(draws)
        rng = np.random.default_rng(
            [int(seed) & 0x7FFFFFFFFFFFFFFF,
             zlib.crc32(self.key(n_workers, d).encode())])
        return rng.random((d, int(n_workers))) < self.p


def parse_fault(spec: str | None) -> FaultSpec | None:
    """Parse a fault spec ``fail:<p>[@restart<T>][x<draws>]``;
    ``None``/``"none"`` -> ``None`` (no faults).  ``p`` is the
    per-iteration per-worker crash probability, ``T`` the
    checkpoint-restore penalty in seconds (default
    :data:`DEFAULT_RESTART_S`), ``draws`` the Monte Carlo draw count
    (default :data:`DEFAULT_DRAWS`)."""
    if spec is None or spec == "none":
        return None
    if not isinstance(spec, str) or not spec.startswith(FAULT_PREFIX):
        raise ValueError(
            f"unknown fault spec {spec!r}: expected 'none' or "
            f"'fail:<p>[@restart<T>][x<draws>]'")
    body = spec[len(FAULT_PREFIX):]
    head, sep, mod = body.partition("@")
    restart = DEFAULT_RESTART_S
    draws_s = None
    if sep:
        if not mod.startswith("restart"):
            raise ValueError(
                f"malformed fault modifier {mod!r} in {spec!r}: "
                f"expected restart<T>")
        restart_s, xsep, tail = mod[len("restart"):].partition("x")
        if xsep:
            draws_s = tail
        try:
            restart = float(restart_s)
        except ValueError:
            raise ValueError(
                f"malformed fault modifier in {spec!r}: restart must "
                f"be a float") from None
    else:
        head, xsep, tail = head.partition("x")
        if xsep:
            draws_s = tail
    try:
        p = float(head)
        draws = int(draws_s) if draws_s is not None else DEFAULT_DRAWS
    except ValueError:
        raise ValueError(
            f"malformed fault spec {spec!r}: p must be a float and "
            f"draws an int") from None
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"fault probability must be in [0, 1] in {spec!r}")
    if restart < 0:
        raise ValueError(f"fault restart penalty must be >= 0 in {spec!r}")
    if not 1 <= draws <= MAX_DRAWS:
        raise ValueError(
            f"fault draws must be in [1, {MAX_DRAWS}] in {spec!r}")
    return FaultSpec(p=p, restart=restart, draws=draws)


def validate_fault(spec: str | None) -> None:
    """Raise ``ValueError`` unless ``spec`` parses (axis validation)."""
    parse_fault(spec)
