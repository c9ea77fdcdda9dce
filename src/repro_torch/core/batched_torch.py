"""The batched sweep on the card: the twin of :mod:`repro.core.batched_jax`.

The NumPy engine (:mod:`repro_torch.core.batched`) evaluates a grid in two
tiers — a policy-independent affine kernel reduced to ``(K,)`` cost
columns, then a cheap per-scenario policy select.  This module runs the
*same* two tiers as torch tensor operations in float64 on one device
(CUDA unless the caller asks for the CPU):

* tier 1 (:func:`_kernel_cols_torch`) mirrors
  :func:`repro_torch.core.batched._kernel_cols` — the affine collective
  coefficients (:mod:`repro_torch.core.hardware` ``*_coeffs``, the same
  polymorphic functions the NumPy kernel calls), the unique-compute-row
  backward tables (structure from
  :func:`repro_torch.core.batched._compute_row_map` on the host, gathered
  on the device) and the fused multiply-add + masked-max residuals;
* tier 2 (:func:`_select_torch`) mirrors
  :func:`repro_torch.core.batched._policy_select` — the same
  ``where``/``maximum`` equation select over ``(S,)`` vectors.

The reference's tiers are ``jnp`` gathers, cumulative sums, ``where`` and
max under ``jax.jit``, and reach no Pallas kernel; their counterpart here
is torch's own tensor operations, with no kernel of the port's.  Every
tensor is made with an explicit float64 / int64 / bool dtype on the
evaluator's device (the counterpart of the reference's scoped
``enable_x64``; the default dtype is never touched), and the tables and
code vectors move to the device once, at construction: an evaluator built
for CUDA never computes on the CPU.  The per-workload prefix/suffix
tables (``cumgrad``/``cumcount``, bucket suffix sums via
:func:`repro_torch.core.bucketsim.suffix_tables`) are the NumPy engine's
own host arrays, shipped in once.  The straggler Monte Carlo tails stay
the host pass shared with the NumPy engine
(:func:`repro_torch.core.batched._apply_mc_tails`), so both backends
consume the same draws.

Differentiability: the continuous inputs — link bandwidths/latencies per
``(cluster, interconnect)`` pair and the bucket sizes — are exposed as a
params dict (:func:`default_params`); :func:`iteration_time_fn` returns a
function of them that ``torch.autograd`` differentiates.  Iteration time
is *piecewise constant* in ``bucket_bytes`` (the bucket size enters only
through the partition boundaries, which are discrete and prebuilt), so
its exact gradient is 0 almost everywhere: ``bucket_bytes`` reaches no
operation, and :func:`grad_iteration_time` returns exactly 0 for it.
:func:`numpy_iteration_times` is the NumPy twin over the same params
(bucket partitions *rebuilt* from the perturbed sizes), which the
finite-difference tests evaluate.

Not ported: the reference's ``mesh=`` sharding of the scenario axis (one
card has nothing to shard over).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core import analytical, batched, bucketsim
from repro_torch.core.batched import grid_evaluator
from repro_torch.core.hardware import (hierarchical_allreduce_coeffs,
                                       ring_allreduce_coeffs,
                                       tree_allreduce_coeffs)
from repro_torch.core.resulttable import METHOD_LABELS
from repro_torch.core.scenarios import Scenario, ScenarioGrid
from repro_torch.core.xputil import max_or_zero
from repro_torch.device import resolve_device

#: Continuous model inputs exposed to ``torch.autograd`` — per
#: ``(cluster, interconnect)`` pair link parameters plus the bucket sizes
#: of the grid's timeline specs.
PARAM_KEYS = ("intra_bw", "intra_lat", "inter_bw", "inter_lat",
              "bucket_bytes")

#: Numeric columns shared with the NumPy engine's policy select.
_NUMERIC_COLS = ("batch", "iteration_time_s", "samples_per_sec",
                 "speedup", "t_comm_s", "t_comp_s")

#: NumPy dtype kind -> the one torch dtype a table or code vector takes.
_DTYPES = {"f": torch.float64, "i": torch.int64, "b": torch.bool}


def _to_device(arrays: dict, device: torch.device) -> dict:
    """Host arrays -> tensors on ``device`` with explicit dtypes (float64,
    int64, bool); a host array of any other kind is an error."""
    out = {}
    for k, v in arrays.items():
        v = np.array(v, order="C")   # a fresh copy: no negative strides
        out[k] = torch.as_tensor(v, dtype=_DTYPES[v.dtype.kind], device=device)
    return out


# ----------------------------------------------------------------------
# Structure extraction: axis tables -> one flat dict of arrays, prefix/
# suffix and bucket structure included.
# ----------------------------------------------------------------------
def _axes_tables(wax, cax, pax, wtab, device: torch.device) -> tuple[dict, dict]:
    """``(tables, pflags)`` tensor dicts on ``device`` from the NumPy
    engine's axis dataclasses, including the per-workload prefix tables the
    affine formulation gathers (``cumgrad``/``cumcount`` and their totals)
    and the bucket suffix tables per timeline spec.  ``bucket_bytes`` rides
    along purely as a differentiation input: the partition structure
    (``bt<i>_*``) is discrete and prebuilt, the piecewise-constant
    dependence the module docstring describes.

    ``wtab`` is the padded per-worker table
    (:func:`repro_torch.core.het.worker_table_rows`) over the unique
    ``(het profile, n_workers)`` pairs: the kernel reduces the gathered
    rows with :func:`repro_torch.core.analytical.worker_bottleneck` on the
    device.  On all-homogeneous inputs every row is ones and the reduction
    multiplies by exactly 1.0."""
    grad = wax.grad_bytes
    comm_mask = (grad > 0).astype(np.float64)
    cumgrad = np.cumsum(grad, axis=1)
    cumcount = np.cumsum(comm_mask, axis=1)
    tables = {
        "flops": wax.flops, "tf_meas": wax.tf_meas, "tb_meas": wax.tb_meas,
        "bwd_ratio": wax.bwd_ratio,
        "batch_default": wax.batch_default,
        "bytes_per_sample": wax.bytes_per_sample,
        "param_bytes": wax.param_bytes, "t_io_meas": wax.t_io_meas,
        "has_meas_io": wax.has_meas_io,
        "comm_mask": comm_mask, "cumgrad": cumgrad, "cumcount": cumcount,
        "gradsum": cumgrad[:, -1], "ncomm": cumcount[:, -1],
        "intra_bw": cax.intra_bw, "intra_lat": cax.intra_lat,
        "inter_bw": cax.inter_bw, "inter_lat": cax.inter_lat,
        "gpn": cax.gpn, "disk_lat": cax.disk_lat, "disk_bw": cax.disk_bw,
        "h2d_lat": cax.h2d_lat, "h2d_bw": cax.h2d_bw,
        "rate": cax.rate, "hbm_bw": cax.hbm_bw,
        "bucket_bytes": np.array([bb for bb, _ in pax.tl_specs],
                                 dtype=np.float64),
        "w_inv": wtab["inv_speed"], "w_bw": wtab["bw_mult"],
        "w_lat": wtab["lat_mult"],
    }
    for i, (bb, _) in enumerate(pax.tl_specs):
        bt = bucketsim.bucket_table(wax.grad_bytes, bb)
        sufnb, sufcnt = bucketsim.suffix_tables(bt)
        tables[f"bt{i}_release"] = bt.release_layer
        tables[f"bt{i}_mask"] = bt.mask.astype(np.float64)
        tables[f"bt{i}_sufnb"] = sufnb
        tables[f"bt{i}_sufcnt"] = sufcnt
    pflags = {"overlap_io": pax.overlap_io,
              "overlap_comm": pax.overlap_comm,
              "h2d_early": pax.h2d_early,
              "tl_spec": pax.tl_spec}
    return _to_device(tables, device), _to_device(pflags, device)


# ----------------------------------------------------------------------
# Tier 1: the affine kernel over whole code vectors.
# ----------------------------------------------------------------------
def _kernel_cols_torch(tbl: dict, kcodes: dict, ucodes: dict,
                       tl_overlaps: tuple, coll_codes: tuple) -> dict:
    """Policy-independent ``(K,)`` cost columns over whole code vectors —
    the torch twin of :func:`repro_torch.core.batched._kernel_cols`:
    affine collective coefficients, unique-compute-row backward tables
    gathered through the host-precomputed ``uk`` map, and the fused
    multiply-add + masked-max residuals.

    Heterogeneity enters exactly as in the NumPy kernel: ``ucodes["tmul"]``
    (slowest-worker compute multiplier, folded into the unique-row key on
    the host) scales ``t_f``/``t_b``, and the per-point link multipliers —
    reduced from the padded worker table gathered at ``kcodes["hk"]`` —
    derate both link levels before the collective dispatch.  All-ones
    multipliers are bit-identity (IEEE ``x * 1.0 == x``)."""
    w, c = kcodes["w"], kcodes["c"]
    coll, n, batch, uk = kcodes["coll"], kcodes["n"], kcodes["batch"], \
        kcodes["uk"]
    hk = kcodes["hk"]
    uw, uc, ub, ut = ucodes["w"], ucodes["c"], ucodes["batch"], \
        ucodes["tmul"]
    batch_f = torch.where(batch > 0, batch,
                          tbl["batch_default"][w]).to(torch.float64)
    n_f = n.to(torch.float64)

    # compute costs: (U, L) on the unique compute rows only
    ubatch_f = torch.where(ub > 0, ub,
                           tbl["batch_default"][uw]).to(torch.float64)
    tfa = tbl["flops"][uw] * ubatch_f[:, None] / tbl["rate"][uc][:, None]
    scale = (ubatch_f / tbl["batch_default"][uw])[:, None]
    t_f = tfa + tbl["tf_meas"][uw] * scale         # measured rows: exact,
    t_b = tbl["bwd_ratio"][uw][:, None] * tfa \
        + tbl["tb_meas"][uw] * scale               # others +0.0
    t_f = t_f * ut[:, None]            # slowest-worker compute multiplier
    t_b = t_b * ut[:, None]
    prefix_b = torch.cumsum(t_b, dim=1)
    total_b_u = prefix_b[:, -1]
    suffix_b_u = (total_b_u[:, None] - prefix_b) + t_b   # inclusive
    comp_u = t_f.sum(dim=1) + t_b.sum(dim=1)
    total_b = total_b_u[uk]

    # per-point affine collective coefficients: every algorithm present is
    # evaluated on every point and selected by code (the safe_n / safe_g
    # forms keep the unselected branches finite, so their zero gradient
    # stays 0, not 0 * inf).  The heterogeneous collective is gated by its
    # slowest link, so both link levels are derated before the dispatch.
    _, bwmul, latmul = analytical.worker_bottleneck(
        tbl["w_inv"][hk], tbl["w_bw"][hk], tbl["w_lat"][hk])
    intra_bw = tbl["intra_bw"][c] * bwmul
    intra_lat = tbl["intra_lat"][c] * latmul
    inter_bw = tbl["inter_bw"][c] * bwmul
    inter_lat = tbl["inter_lat"][c] * latmul
    use_intra = n <= tbl["gpn"][c]
    link_bw = torch.where(use_intra, intra_bw, inter_bw)
    link_lat = torch.where(use_intra, intra_lat, inter_lat)

    def _model(code: int):
        if code == 0:
            return ring_allreduce_coeffs(n_f, link_bw, link_lat)
        if code == 1:
            return tree_allreduce_coeffs(n, link_bw, link_lat)
        return hierarchical_allreduce_coeffs(
            n, tbl["gpn"][c], intra_bw, intra_lat, inter_bw, inter_lat)

    per_byte, per_message = _model(coll_codes[0])
    for code in coll_codes[1:]:
        a, b = _model(code)
        sel = coll == code
        per_byte = torch.where(sel, a, per_byte)
        per_message = torch.where(sel, b, per_message)

    # pipeline terms: (K,)
    nbytes_in = batch_f * tbl["bytes_per_sample"][w]
    t_io = tbl["disk_lat"][c] + nbytes_in / tbl["disk_bw"][c]
    t_io = torch.where(tbl["has_meas_io"][w],
                       tbl["t_io_meas"][w] * batch_f / tbl["batch_default"][w],
                       t_io)
    t_h2d = tbl["h2d_lat"][c] + nbytes_in / tbl["h2d_bw"][c]

    # WFBP residual (affine form — see the NumPy kernel's derivation)
    cand = suffix_b_u[uk] \
        + per_byte[:, None] * tbl["cumgrad"][w] \
        + per_message[:, None] * tbl["cumcount"][w]
    cand = cand * tbl["comm_mask"][w]
    out = {
        "io_h2d": t_io + t_h2d,
        "t_h2d": t_h2d,
        "comp": comp_u[uk],
        "sum_c": per_byte * tbl["gradsum"][w] + per_message * tbl["ncomm"][w],
        "tc_no": torch.clamp_min(max_or_zero(cand, 1) - total_b, 0.0),
        "t_u": 3.0 * tbl["param_bytes"][w] / tbl["hbm_bw"][c],
        "n_f": n_f,
        "batch_f": batch_f,
    }
    for i, ov_comm in enumerate(tl_overlaps):
        release = tbl[f"bt{i}_release"][uw]
        if ov_comm:
            release_u = torch.take_along_dim(suffix_b_u, release, dim=1)
        else:
            release_u = total_b_u[:, None].expand(release.shape)
        cand = release_u[uk] \
            + per_byte[:, None] * tbl[f"bt{i}_sufnb"][w] \
            + per_message[:, None] * tbl[f"bt{i}_sufcnt"][w]
        cand = cand * tbl[f"bt{i}_mask"][w]
        out[f"tl{i}"] = torch.clamp_min(max_or_zero(cand, 1) - total_b, 0.0)
    return out


# ----------------------------------------------------------------------
# Tier 2: the policy select over whole scenario vectors.
# ----------------------------------------------------------------------
def _select_torch(pflags: dict, tl_overlaps: tuple, kc: dict, pi, kidx):
    """The torch twin of :func:`repro_torch.core.batched._policy_select`
    (same equations, same zero-comm weak-scaling baseline), over whole
    ``(S,)`` vectors; method labels are strings and stay on the host."""
    def g(name):
        return kc[name][kidx]

    ov_io = pflags["overlap_io"][pi]
    ov_comm = pflags["overlap_comm"][pi]
    early = pflags["h2d_early"][pi]

    comm_term = torch.where(ov_comm, g("tc_no"), g("sum_c"))
    spec_of = pflags["tl_spec"][pi]
    for i, _ in enumerate(tl_overlaps):
        comm_term = torch.where(spec_of == i, g(f"tl{i}"), comm_term)
    gpu_chain = g("comp") + comm_term + g("t_u")
    io_h2d, t_h2d = g("io_h2d"), g("t_h2d")
    eq2 = io_h2d + gpu_chain
    eq_early = torch.maximum(io_h2d, gpu_chain)
    eq_late = torch.maximum(io_h2d, t_h2d + gpu_chain)
    t_iter = torch.where(~ov_io, eq2, torch.where(early, eq_early, eq_late))

    base_chain = g("comp") + g("t_u")
    t1 = torch.where(~ov_io, io_h2d + base_chain,
                     torch.where(early, torch.maximum(io_h2d, base_chain),
                                 torch.maximum(io_h2d, t_h2d + base_chain)))
    n_f, batch_f = g("n_f"), g("batch_f")
    return {
        "batch": batch_f,
        "iteration_time_s": t_iter,
        "samples_per_sec": n_f * batch_f / t_iter,
        "speedup": n_f * t1 / t_iter,
        "t_comm_s": g("sum_c"),
        "t_comp_s": g("comp"),
    }


def _columns_torch(tables: dict, pflags: dict, kcodes: dict, scodes: dict,
                   ucodes: dict, tl_overlaps: tuple,
                   coll_codes: tuple) -> dict:
    """The whole two-tier evaluation — codes in, result columns out, as
    tensors on the tables' device."""
    kc = _kernel_cols_torch(tables, kcodes, ucodes, tl_overlaps, coll_codes)
    return _select_torch(pflags, tl_overlaps, kc, scodes["pi"],
                         scodes["kidx"])


def require_all_batched(ev: batched.GridEvaluator, backend: str) -> None:
    """Raise ``ValueError`` naming the grid's policies that have neither a
    closed nor a bucket-timeline form: they need the event-driven
    simulator, which the port's sweep does not run, and silently dropping
    or approximating their rows would defeat the point of the sweep."""
    if ev.all_batched:
        return
    bad = [name for name, f, t in zip(
        ev._pax.names, ev._pax.has_fast, ev._pax.has_tl)
        if not (bool(f) or bool(t))]
    raise ValueError(
        f"backend={backend!r} evaluates closed-form and bucket-timeline "
        f"policies only; {bad} need the event-driven simulator, which "
        f"the port's sweep does not run (the reference's "
        f"repro.core.sweep with backend='numpy' does).")


# ----------------------------------------------------------------------
# Grid front end.
# ----------------------------------------------------------------------
class TorchGridEvaluator:
    """A :class:`ScenarioGrid` prepared for the two tiers on one device.

    Reuses the NumPy engine's memoized structure (axis tables, code
    vectors, label arrays, unique-compute-row map) and moves the tables and
    codes to ``device`` (:func:`repro_torch.device.resolve_device`: CUDA
    unless ``"cpu"`` is asked for) once.  Raises ``ValueError`` for grids
    containing simulator-only policies (:func:`require_all_batched`)."""

    def __init__(self, grid: ScenarioGrid, *, device=None):
        self.device = resolve_device(device)
        ev = grid_evaluator(grid)
        require_all_batched(ev, "torch")
        self.ev = ev
        self._tables, self._pflags = _axes_tables(
            ev._wax, ev._cax, ev._pax, ev._wtab, self.device)
        self._tl_overlaps = tuple(bool(ov) for _, ov in ev._pax.tl_specs)
        self._coll_codes = tuple(int(x) for x in np.unique(ev._kcoll)) or (0,)
        uw, uc, ub, ut, uk = batched._compute_row_map(
            ev._wax, ev._cax, ev._kwidx, ev._kcidx, ev._kbatch, ev._ktmul)
        self._kcodes = _to_device(
            {"w": ev._kwidx, "c": ev._kcidx, "coll": ev._kcoll,
             "n": ev._kn, "batch": ev._kbatch, "uk": uk, "hk": ev._khk},
            self.device)
        self._ucodes = _to_device(
            {"w": uw, "c": uc, "batch": ub,
             "tmul": np.ones(len(uw)) if ut is None else ut}, self.device)
        S = len(ev)
        if S:
            sc = ev._scenario_codes(0, S)
            scodes = {"pi": sc["pi"], "kidx": sc["kidx"]}
        else:
            scodes = {"pi": np.empty(0, dtype=np.int64),
                      "kidx": np.empty(0, dtype=np.int64)}
        self._scodes = _to_device(scodes, self.device)
        # "cuda" resolves to the current card: name it ("cuda:0"), so that
        # params are checked against the device the tables are on
        self.device = self._scodes["pi"].device

    def __len__(self) -> int:
        return len(self.ev)

    def device_columns(self, params: dict | None = None) -> dict:
        """The numeric result columns as float64 ``(S,)`` tensors on the
        evaluator's device (asynchronous on CUDA).  ``params`` optionally
        overrides the :data:`PARAM_KEYS` entries: host arrays move to the
        device, tensors must already be there (they may require grad)."""
        tables = self._tables
        if params:
            unknown = set(params) - set(PARAM_KEYS)
            if unknown:
                raise ValueError(f"unknown param keys {sorted(unknown)}; "
                                 f"differentiable params are {PARAM_KEYS}")
            over = {}
            for k, v in params.items():
                if isinstance(v, torch.Tensor):
                    if v.device != self.device or v.dtype != torch.float64:
                        raise ValueError(
                            f"param {k!r} is a {v.dtype} tensor on {v.device}; "
                            f"the evaluator computes in torch.float64 on "
                            f"{self.device}")
                    over[k] = v
                else:
                    over[k] = torch.as_tensor(np.asarray(v, dtype=np.float64),
                                              dtype=torch.float64,
                                              device=self.device)
            tables = {**tables, **over}
        out = _columns_torch(tables, self._pflags, self._kcodes,
                             self._scodes, self._ucodes, self._tl_overlaps,
                             self._coll_codes)
        return {k: v for k, v in out.items() if k in _NUMERIC_COLS}

    def columns(self, params: dict | None = None) -> dict[str, np.ndarray]:
        """All numeric result columns as host float64 ``(S,)`` arrays (waits
        for the device)."""
        if len(self.ev) == 0:
            return {k: np.empty(0) for k in _NUMERIC_COLS}
        return {k: v.detach().cpu().numpy()
                for k, v in self.device_columns(params).items()}

    def run(self, params: dict | None = None, seed: int = 0) -> "TorchGridRun":
        """One evaluation: the two tiers on the device for the deterministic
        columns, then the straggler Monte Carlo tail pass on the host,
        shared with the NumPy engine
        (:func:`repro_torch.core.batched._apply_mc_tails`), which is what
        gives draw-for-draw agreement between the backends; deterministic
        grids skip it and the tail columns equal ``iteration_time_s``."""
        cols = self.columns(params)
        ev = self.ev
        if ev._any_mc and len(ev):
            codes = ev._scenario_codes(0, len(ev))
            k = codes["kidx"]
            batched._apply_mc_tails(
                ev._wax, ev._cax, ev._pax, ev._kwidx[k], ev._kcidx[k],
                ev._kcoll[k], ev._kn[k], ev._kbatch[k], codes["pi"],
                ev._khk[k], ev._wtab,
                None if ev._kbwmul is None else ev._kbwmul[k],
                None if ev._klatmul is None else ev._klatmul[k],
                ev._st_specs, codes["sti"], cols, seed,
                synck=ev._ksynck[k], ft_specs=ev._ft_specs,
                fidx=codes["fli"])
        else:
            t_iter = cols["iteration_time_s"]
            cols["t_mean_s"] = t_iter
            cols["t_p95_s"] = t_iter
            cols["t_p99_s"] = t_iter
        return TorchGridRun(self, cols)

    def method_labels(self, pi: np.ndarray) -> list[str]:
        """Per-row evaluation-path labels (``all_batched`` holds, so only
        the two batched labels occur)."""
        return METHOD_LABELS[self.ev._pax.tier[pi]].tolist()


class TorchGridRun:
    """One evaluation of a grid on the torch backend: host numeric columns
    plus the shared structure, materializing columnar result tables by row
    range — the twin of :class:`repro_torch.core.batched.GridRun` (no
    simulator rows: simulator-only grids are rejected up front)."""

    def __init__(self, tev: TorchGridEvaluator, cols: dict[str, np.ndarray]):
        self._tev = tev
        self._cols = cols

    def __len__(self) -> int:
        return len(self._tev)

    def columns_slice(self, lo: int, hi: int) -> dict[str, np.ndarray]:
        ev = self._tev.ev
        out = {k: v[lo:hi] for k, v in self._cols.items()}
        out["method"] = self._tev.method_labels(
            ev._scenario_codes(lo, hi)["pi"])
        return out

    def table_slice(self, lo: int, hi: int):
        """Columnar result table for flat scenario indices ``[lo, hi)`` in
        grid order, and the per-row batched mask (all true)."""
        ev = self._tev.ev
        codes = ev._scenario_codes(lo, hi)
        cols = {k: v[lo:hi] for k, v in self._cols.items()}
        cols["method_code"] = ev._pax.tier[codes["pi"]]
        return (batched.select_to_columns(cols, ev._label_columns(codes)),
                codes["batched"])


#: Structure memo, mirroring :func:`repro_torch.core.batched.grid_evaluator`
#: (separate because the torch evaluator also holds device-side tensors),
#: keyed by grid value, workload-table identity and device.
_TORCH_MEMO: dict = {}
_MEMO_LIMIT = 64


def _memo_key(grid: ScenarioGrid, device: torch.device):
    from repro_torch.core.workloads import resolve_workload

    tables = tuple(resolve_workload(w) for w in grid.workloads)
    key = (grid, tuple(id(t) for t in tables), str(device))
    hash(key)
    return key, tables


def torch_grid_evaluator(grid: ScenarioGrid, *, device=None) -> TorchGridEvaluator:
    """Memoized :class:`TorchGridEvaluator` (a fresh one when the grid is
    not hashable)."""
    dev = resolve_device(device)
    try:
        key, tables = _memo_key(grid, dev)
    except TypeError:
        return TorchGridEvaluator(grid, device=dev)
    hit = _TORCH_MEMO.get(key)
    if hit is not None:
        return hit[0]
    if len(_TORCH_MEMO) >= _MEMO_LIMIT:
        _TORCH_MEMO.clear()
    tev = TorchGridEvaluator(grid, device=dev)
    _TORCH_MEMO[key] = (tev, tables)
    return tev


# ----------------------------------------------------------------------
# Scenario-list front end — twin of batched.eval_scenarios_table.
# ----------------------------------------------------------------------
def eval_scenarios_table_torch(
        scenarios: Sequence[Scenario] | Iterable[Scenario],
        seed: int = 0, *, device=None) -> dict[str, np.ndarray]:
    """Columnar result table (input order) for a list of
    batched-path-eligible scenarios, evaluated by the two tiers on the
    device with the identity scenario -> kernel-point map; het/straggler
    structure from the shared
    :func:`repro_torch.core.batched.scenario_het_axes` pass and the
    straggler Monte Carlo tails from the shared host pass, exactly as on
    the grid path.  Raises ``ValueError`` (via
    :func:`repro_torch.core.batched.scenario_axes`) if any scenario's
    policy has neither a closed nor a bucket-timeline form."""
    from repro_torch.core.resulttable import empty_table

    dev = resolve_device(device)
    scenarios = list(scenarios)
    if not scenarios:
        return empty_table()
    wax, cax, pax, widx, cidx, polidx, coll, n, batch = \
        batched.scenario_axes(scenarios)
    (hks, wtab, tmul, bwmul, latmul, st_specs, stidx,
     synck, ft_specs, fidx) = batched.scenario_het_axes(scenarios)
    tables, pflags = _axes_tables(wax, cax, pax, wtab, dev)
    tl_overlaps = tuple(bool(ov) for _, ov in pax.tl_specs)
    S = len(scenarios)
    uw, uc, ub, ut, uk = batched._compute_row_map(wax, cax, widx, cidx,
                                                  batch, tmul)
    kcodes = _to_device({"w": widx, "c": cidx, "coll": coll, "n": n,
                         "batch": batch, "uk": uk, "hk": hks}, dev)
    ucodes = _to_device({"w": uw, "c": uc, "batch": ub,
                         "tmul": np.ones(len(uw)) if ut is None else ut}, dev)
    scodes = _to_device({"pi": polidx,
                         "kidx": np.arange(S, dtype=np.int64)}, dev)
    coll_codes = tuple(int(x) for x in np.unique(coll)) or (0,)
    out = _columns_torch(tables, pflags, kcodes, scodes, ucodes,
                         tl_overlaps, coll_codes)
    cols = {k: v.cpu().numpy() for k, v in out.items() if k in _NUMERIC_COLS}
    batched._apply_mc_tails(wax, cax, pax, widx, cidx, coll, n, batch,
                            polidx, hks, wtab, bwmul, latmul, st_specs,
                            stidx, cols, seed, synck=synck,
                            ft_specs=ft_specs, fidx=fidx)
    cols["method_code"] = pax.tier[polidx]
    return batched.select_to_columns(cols,
                                     batched.scenario_labels(scenarios))


# ----------------------------------------------------------------------
# Differentiable front end.
# ----------------------------------------------------------------------
def default_params(grid: ScenarioGrid, *, device=None) -> dict[str, np.ndarray]:
    """The grid's resolved continuous inputs (:data:`PARAM_KEYS`): per-pair
    link bandwidths/latencies and per-timeline-spec bucket sizes, as host
    float64 arrays — the point :func:`iteration_time_fn` differentiates
    around."""
    tev = torch_grid_evaluator(grid, device=device)
    return {k: tev._tables[k].cpu().numpy().copy() for k in PARAM_KEYS}


def iteration_time_fn(grid: ScenarioGrid, *, device=None):
    """``(f, params0)``: ``f(params) -> (S,)`` float64 iteration times on
    the evaluator's device, differentiable by ``torch.autograd`` in every
    :data:`PARAM_KEYS` entry passed as a float64 tensor on that device
    (host arrays are taken as constants).

    The gradient in ``bucket_bytes`` is exactly 0: iteration time is
    piecewise constant in the bucket size (see the module docstring), and
    ``f`` holds the partition fixed at ``params0``'s structure.
    :func:`numpy_iteration_times` *rebuilds* the partition per call, so
    central differences on it recover the same 0 inside a partition
    cell."""
    tev = torch_grid_evaluator(grid, device=device)

    def f(params: dict):
        return tev.device_columns(params)["iteration_time_s"]

    return f, default_params(grid, device=device)


def grad_iteration_time(grid: ScenarioGrid, params: dict | None = None, *,
                        device=None) -> dict[str, np.ndarray]:
    """``d(sum of iteration times)/d(params)`` as host float64 arrays,
    through ``torch.autograd`` on float64 leaves on the device — the
    differentiability surface the gradient tests pin against NumPy central
    differences.  A param no operation reads (``bucket_bytes``) gets an
    exact 0."""
    f, p0 = iteration_time_fn(grid, device=device)
    if params:
        p0 = {**p0, **params}
    dev = torch_grid_evaluator(grid, device=device).device
    leaves = {k: torch.tensor(np.asarray(v, dtype=np.float64),
                              dtype=torch.float64, device=dev,
                              requires_grad=True)
              for k, v in p0.items()}
    f(leaves).sum().backward()
    return {k: (np.zeros(v.shape) if v.grad is None
                else v.grad.cpu().numpy()) for k, v in leaves.items()}


def numpy_iteration_times(grid: ScenarioGrid,
                          params: dict | None = None) -> np.ndarray:
    """The NumPy oracle over the same params surface: link overrides swap
    into the cluster axis, bucket-size overrides *rebuild* the bucket
    partitions.  The finite-difference reference for
    :func:`grad_iteration_time`."""
    ev = grid_evaluator(grid)
    cax = ev._cax
    tl_specs = list(ev._pax.tl_specs)
    if params:
        link = {k: np.asarray(params[k], dtype=np.float64)
                for k in ("intra_bw", "intra_lat", "inter_bw", "inter_lat")
                if k in params}
        if link:
            cax = dataclasses.replace(cax, **link)
        if "bucket_bytes" in params:
            bb = np.asarray(params["bucket_bytes"], dtype=np.float64)
            tl_specs = [(float(bb[i]), ov)
                        for i, (_, ov) in enumerate(tl_specs)]
    kc = batched._kernel_cols(ev._wax, cax, ev._kwidx, ev._kcidx,
                              ev._kcoll, ev._kn, ev._kbatch,
                              tl_specs=tl_specs, tmul=ev._ktmul,
                              bwmul=ev._kbwmul, latmul=ev._klatmul)
    codes = ev._scenario_codes(0, len(ev))
    return batched._policy_select(ev._pax, codes["pi"], kc,
                                  codes["kidx"])["iteration_time_s"]
