"""The program's own spans (:mod:`repro_torch.tracing`) on the S-SGD step.

CPU, tiny widths through the plain path: off, the step is the same bit for
bit and holds nothing of the tracer; on, every unit has one forward and one
backward span (the backward ones last unit first, one a unit under remat
too), parents are right, the children of ``step`` lie in order inside it
(the rest of the step, its tail, is ``step`` less them), the model's
segments tile their parents, nothing inside a step waits for the device, a
resolved step is folded into totals and not held, the
loader's wait is counted, and the launcher's paper-format trace reads back.
The ``cuda`` tests run on the card
(``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_tracing.py``):
the backward spans come from the autograd engine's device thread, events
are resolved after their step, and the tracer leaves the device's busy time
and its kernel names as they were.  Imports no JAX.
"""
import threading
import time

import pytest
import torch

from repro_torch import tracing
from repro_torch.comm.ddp import make_ddp_train_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import PrefetchLoader, SyntheticLMDataset
from repro_torch.launch import steps as S
from repro_torch.launch import train as ttrain
from repro_torch.optim.sgd import sgd
from repro_torch.traces.format import read_trace
from repro_torch.traces.recorded import layer_times, paper_trace

UNITS = 3
#: 16 384 tokens: the chunked cross-entropy, whose forward and backward are spans
VOCAB = 16_384


def _cfg(**over):
    return get_config("internlm2-20b").reduced(
        num_layers=UNITS, d_model=32, num_heads=4, d_ff=64, vocab_size=VOCAB, **over)


def _batch(cfg, seed=0, rows=2, seq=16, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (rows, seq + 1), generator=g)
    return {"tokens": tok[:, :-1].to(device), "labels": tok[:, 1:].to(device)}


def _ddp_step(cfg, params):
    opt = sgd(0.1)
    return make_ddp_train_step(cfg, opt, None, "none"), opt.init(params)


def _recording(device="cpu"):
    """A :func:`tracing.record` block and the list its resolved steps go to,
    as (index, spans)."""
    steps = []
    return tracing.record(device, on_step=lambda i, spans: steps.append((i, spans))), steps


def _spans(steps, step=0):
    return steps[step][1]


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


def _by_id(spans):
    return {s["id"]: s for s in spans}


def _graph_names(t):
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def _traced_ddp_steps(cfg, n=2, device="cpu"):
    params = S.init_params(cfg, seed=0, device=device)
    step, state = _ddp_step(cfg, params)
    recording, steps = _recording(device)
    with recording as rec:
        for i in range(n):
            params, state, m = step(params, state, _batch(cfg, i, device=device))
            float(m["loss"])
        rec.summary()
    return rec, steps


# ----------------------------------------------------------------------
# Off
# ----------------------------------------------------------------------
class TestOff:
    def test_loss_and_grads_is_the_same_bit_for_bit(self):
        cfg = _cfg()
        params = S.init_params(cfg, seed=1)
        b = _batch(cfg)
        off = S.loss_and_grads(cfg, params, b["tokens"], b["labels"])
        with tracing.record("cpu") as rec:
            on = S.loss_and_grads(cfg, params, b["tokens"], b["labels"])
        assert torch.equal(off[0], on[0])
        for (path, g_off), (_, g_on) in zip(S.T.leaf_order(off[2]), S.T.leaf_order(on[2])):
            assert torch.equal(g_off, g_on), path
        held = len(rec.summary()["spans"])
        assert held and tracing.current() is None
        S.loss_and_grads(cfg, params, b["tokens"], b["labels"])
        assert len(rec.summary()["spans"]) == held and not rec._stack

    def test_the_ddp_step_is_the_same_bit_for_bit(self):
        cfg = _cfg()
        results = []
        for on in (False, True):
            params = S.init_params(cfg, seed=2)
            step, state = _ddp_step(cfg, params)
            with tracing.record("cpu") if on else tracing._OFF:
                for i in range(2):
                    params, state, m = step(params, state, _batch(cfg, i))
            results.append((params, state, m))
        (p0, s0, m0), (p1, s1, m1) = results
        for k in m0:
            assert torch.equal(m0[k], m1[k]), k
        for (path, a), (_, b) in zip(S.T.leaf_order(p0), S.T.leaf_order(p1)):
            assert torch.equal(a, b), path
        for (path, a), (_, b) in zip(S.T.leaf_order(s0), S.T.leaf_order(s1)):
            assert torch.equal(a, b), path

    def test_no_tracer_node_in_the_graph(self):
        cfg = _cfg()
        params = S.init_params(cfg, seed=0)
        for _, leaf in S.T.leaf_order(params):
            leaf.requires_grad_(True)
        b = _batch(cfg)
        total, _ = S.model_loss(cfg, params, b["tokens"], b["labels"])
        assert "_BoundaryBackward" not in _graph_names(total)
        with tracing.record("cpu"), tracing.span("fwd"):
            total, _ = S.model_loss(cfg, params, b["tokens"], b["labels"])
        assert _graph_names(total).count("_BoundaryBackward") == UNITS + 1

    def test_off_makes_no_event_and_no_span(self, monkeypatch):
        made = []
        monkeypatch.setattr(tracing.Recorder, "_mark", lambda self: made.append(1))
        assert tracing.span("step") is tracing.span("fwd") is tracing.timed("loader.wait")
        x = torch.ones(3, requires_grad=True)
        assert tracing.boundary(x, "unit", 0) is x
        cfg = _cfg()
        params = S.init_params(cfg, seed=0)
        step, state = _ddp_step(cfg, params)
        step(params, state, _batch(cfg))
        assert not made


# ----------------------------------------------------------------------
# On
# ----------------------------------------------------------------------
class TestOn:
    @pytest.mark.parametrize("remat", [False, True])
    def test_one_forward_and_one_backward_span_a_unit(self, remat):
        cfg = _cfg()
        params = S.init_params(cfg, seed=0)
        opt = sgd(0.1)
        step = S.make_train_step(cfg, opt, remat=remat)
        state = opt.init(params)
        recording, steps = _recording()
        with recording as rec:
            for i in range(2):
                params, state, m = step(params, state, _batch(cfg, i))
            summary = rec.summary()
        assert summary["steps"] == 2
        assert [i for i, _ in steps] == [0, 1]
        for st in range(2):
            spans = _spans(steps, st)
            assert [s["unit"] for s in _named(spans, "fwd.unit")] == list(range(UNITS))
            bwd = sorted(_named(spans, "bwd.unit"), key=lambda s: s["start_ms"])
            assert [s["unit"] for s in bwd] == list(reversed(range(UNITS)))
            for name in ("step", "fwd", "bwd", "fwd.embed", "fwd.head", "bwd.head",
                         "bwd.embed", "fwd.loss", "bwd.loss", "update"):
                assert len(_named(spans, name)) == 1, name

    def test_parents(self):
        _, steps = _traced_ddp_steps(_cfg())
        spans = _spans(steps)
        ids = _by_id(spans)

        def parent(s):
            return None if s["parent"] is None else ids[s["parent"]]["name"]

        want = {"step": None, "fwd": "step", "bwd": "step",
                "update": "step", "fwd.embed": "fwd", "fwd.unit": "fwd",
                "fwd.head": "fwd", "fwd.loss": "fwd.head", "bwd.head": "bwd",
                "bwd.unit": "bwd", "bwd.embed": "bwd", "bwd.loss": "bwd.head"}
        assert {s["name"] for s in spans} == set(want)
        for s in spans:
            assert parent(s) == want[s["name"]], s["name"]

    def test_the_children_of_step_tile_it(self):
        _, steps = _traced_ddp_steps(_cfg(), n=3)
        for st in range(3):
            spans = _spans(steps, st)
            (step,) = _named(spans, "step")
            kids = sorted((s for s in spans if s["parent"] == step["id"]),
                          key=lambda s: s["start_ms"])
            assert [s["name"] for s in kids] == ["fwd", "bwd", "update"]
            assert step["start_ms"] == 0.0 <= kids[0]["start_ms"]
            for x, y in zip(kids, kids[1:]):
                assert x["start_ms"] <= x["end_ms"] <= y["start_ms"]
            assert kids[-1]["end_ms"] <= step["end_ms"]

    def test_the_model_segments_tile_fwd_and_bwd(self):
        _, steps = _traced_ddp_steps(_cfg())
        spans = _spans(steps)
        for way in ("fwd", "bwd"):
            (whole,) = _named(spans, way)
            segs = sorted((s for s in spans if s["parent"] == whole["id"]),
                          key=lambda s: s["start_ms"])
            names = [s["name"] for s in segs]
            order = ["embed", *["unit"] * UNITS, "head"]
            assert names == [f"{way}.{k}" for k in (order if way == "fwd" else order[::-1])]
            assert segs[0]["start_ms"] == whole["start_ms"]
            assert segs[-1]["end_ms"] == whole["end_ms"]
            for x, y in zip(segs, segs[1:]):
                assert x["end_ms"] == y["start_ms"]
            (loss,) = _named(spans, f"{way}.loss")
            head = _by_id(spans)[loss["parent"]]
            assert head["start_ms"] <= loss["start_ms"]
            assert loss["end_ms"] <= head["end_ms"]

    def test_no_wait_for_the_device_inside_a_traced_step(self, monkeypatch):
        cfg = _cfg()
        params = S.init_params(cfg, seed=0)
        step, state = _ddp_step(cfg, params)
        calls = []

        def counted(name, fn):
            def wrapper(*a, **k):
                calls.append(name)
                return fn(*a, **k)
            return wrapper

        with tracing.record("cpu"):
            params, state, m = step(params, state, _batch(cfg, 0))
            m["loss"].item()
            with monkeypatch.context() as mp:
                mp.setattr(torch.cuda, "synchronize",
                           counted("synchronize", torch.cuda.synchronize))
                mp.setattr(torch.Tensor, "item", counted("item", torch.Tensor.item))
                mp.setattr(torch.Tensor, "cpu", counted("cpu", torch.Tensor.cpu))
                step(params, state, _batch(cfg, 1))
        assert calls == []

    def test_a_step_is_resolved_inside_the_next_one(self):
        recording, steps = _recording()
        with recording as rec:
            for i in range(2):
                with tracing.span("step"):
                    assert rec.resolved == max(i - 1, 0)
                    with tracing.span("fwd"):
                        pass
                    assert rec.resolved == i and len(rec._pending) == 1
            assert rec.resolved == 1
            rec.summary()
        assert [i for i, _ in steps] == [0, 1] and not rec._pending

    def test_a_span_closed_out_of_order_raises(self):
        with tracing.record("cpu") as rec:
            outer = rec._open("step")
            rec._open("fwd")
            with pytest.raises(RuntimeError, match="closed while"):
                rec._close(outer)

    @pytest.mark.parametrize("depth", [0, 2])
    def test_the_loader_wait_is_counted(self, depth):
        loader = PrefetchLoader(SyntheticLMDataset(50, 8, 2, simulate_io_seconds=0.01),
                                depth=depth, device="cpu")
        try:
            with tracing.record("cpu") as rec:
                for _ in range(3):
                    next(loader)
                    with tracing.span("step"):
                        time.sleep(0.001)
                summary = rec.summary()
        finally:
            loader.close()
        assert summary["steps"] == 3
        wait = summary["counters"]["loader.wait"]
        assert wait > 0 and set(summary["counters"]) == {"loader.wait"}
        if depth == 0:
            assert wait >= 3 * 0.01
        assert loader.batches >= 3 and loader.mean_t_io() >= 0.01

    def test_a_resolved_step_is_folded_not_held(self):
        held = []
        for n in (2, 4):
            rec, _ = _traced_ddp_steps(_cfg(), n=n)
            assert rec.resolved == n and not rec._pending and rec._step is None
            held.append(sorted(rec.totals))
        assert held[0] == held[1]
        assert not [k for k in vars(rec) if isinstance(getattr(rec, k), list) and
                    getattr(rec, k)]

    def test_the_summary_sums_each_name(self):
        rec, steps = _traced_ddp_steps(_cfg(), n=2)
        summary = rec.summary()
        assert summary["device"] == "cpu" and summary["steps"] == 2
        every = [s for _, spans in steps for s in spans]
        assert set(summary["spans"]) == {s["name"] for s in every}
        for name, t in summary["spans"].items():
            mine = _named(every, name)
            assert t == {"count": len(mine), "device_ms": pytest.approx(
                sum(s["end_ms"] - s["start_ms"] for s in mine))}
        assert summary["spans"]["fwd.unit"]["count"] == 2 * UNITS


# ----------------------------------------------------------------------
# The paper-format trace
# ----------------------------------------------------------------------
class TestPaperTrace:
    def test_layers_times_and_bytes(self):
        cfg = _cfg()
        _, steps = _traced_ddp_steps(cfg, n=2)
        params = S.init_params(cfg, seed=0)
        trace = paper_trace([layer_times(spans) for _, spans in steps], params, cfg.name,
                            "torch-cpu-x1")
        assert len(trace.iterations) == 2
        names = [r.name for r in trace.iterations[0]]
        assert names == ["embed", *[f"unit{u}" for u in range(UNITS)], "head"]
        assert [r.layer_id for r in trace.iterations[0]] == list(range(UNITS + 2))
        spans = _spans(steps, 1)
        for name in ("embed", "head"):
            (s,) = _named(spans, f"fwd.{name}")
            got = trace.iterations[1][names.index(name)].forward_us
            assert got == pytest.approx((s["end_ms"] - s["start_ms"]) * 1e3)
        assert trace.iterations[0][0].size_bytes == cfg.vocab_size * cfg.d_model * 4
        unit_bytes = sum(leaf[0].numel() * 4 for p, leaf in S.T.leaf_order(params)
                         if p[0] == "units")
        assert all(r.size_bytes == unit_bytes for r in trace.iterations[0][1:-1])
        assert sum(r.size_bytes for r in trace.iterations[0]) == \
            sum(leaf.numel() * 4 for _, leaf in S.T.leaf_order(params))
        assert all(r.comm_us == 0 and r.backward_us > 0 for r in trace.iterations[0])

    def test_a_run_without_the_model_has_no_trace(self):
        recording, steps = _recording()
        with recording as rec, tracing.span("step"):
            pass
        rec.summary()
        assert len(steps) == 1 and layer_times(steps[0][1]) == {}
        with pytest.raises(ValueError, match="boundaries"):
            paper_trace([layer_times(spans) for _, spans in steps], S.init_params(_cfg()),
                        "x", "y")

    def test_the_launcher_writes_a_trace_that_reads_back(self, tmp_path):
        out = tmp_path / "run.trace"
        ttrain.run(ttrain.build_argparser().parse_args(
            ["--arch", "internlm2-20b", "--steps", "4", "--batch", "2", "--seq", "16",
             "--policy", "single", "--device", "cpu", "--trace-out", str(out)]))
        trace = read_trace(out)
        assert trace.network == "internlm2-20b-reduced"
        assert trace.cluster == "torch-cpu-x1" and trace.batch_per_gpu == 2
        assert len(trace.iterations) == 4 - ttrain.WARM_STEPS
        assert [r.name for r in trace.iterations[0]] == ["embed", "unit0", "unit1", "head"]
        assert all(r.forward_us > 0 and r.backward_us > 0 for r in trace.iterations[0])
        assert len(trace.to_iteration_costs(data_layer_as_io=False).t_f) == 4

    def test_the_launcher_refuses_a_trace_of_many_ranks(self, tmp_path):
        with pytest.raises(SystemExit, match="one process"):
            ttrain.run(ttrain.build_argparser().parse_args(
                ["--steps", "1", "--data-parallel", "2", "--device", "cpu",
                 "--trace-out", str(tmp_path / "x")]))


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    """Decided when each test runs, not at import: every worker collects
    the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: events are timed on the card")
    return torch.device("cuda")


def _card_cfg():
    """A bf16 internlm2 shape of ~0.1 s a step at 1 x 4096, where the host
    runs ahead of the device as at published widths: the flash kernels at
    hd 128 and a GQA group of 4, the chunked loss."""
    return get_config("internlm2-20b").reduced(
        num_layers=4, d_model=2048, num_heads=16, num_kv_heads=4, d_ff=8192,
        vocab_size=VOCAB, dtype=torch.bfloat16)


@pytest.mark.cuda
class TestOnCard:
    def test_backward_marks_come_from_the_engine_thread(self, card, monkeypatch):
        threads = []
        mark = tracing.Recorder._boundary

        def spy(self, kind, unit, backward):
            threads.append((backward, threading.get_ident()))
            return mark(self, kind, unit, backward)

        monkeypatch.setattr(tracing.Recorder, "_boundary", spy)
        cfg = _card_cfg()
        params = S.init_params(cfg, seed=0, device=card)
        step, state = _ddp_step(cfg, params)
        b = _batch(cfg, rows=1, seq=4096, device=card)
        recording, steps = _recording(card)
        with recording as rec:
            for _ in range(2):
                params, state, m = step(params, state, b)
                float(m["loss"])
            # the first step was resolved inside the second one
            assert rec.resolved == 1
            summary = rec.summary()
        main = threading.get_ident()
        assert {t for bw, t in threads if not bw} == {main}
        assert main not in {t for bw, t in threads if bw}
        assert summary["device"] == "cuda" and summary["steps"] == 2
        for st in range(2):
            spans = _spans(steps, st)
            (step_,) = _named(spans, "step")
            kids = sorted((s for s in spans if s["parent"] == step_["id"]),
                          key=lambda s: s["start_ms"])
            assert [s["name"] for s in kids] == ["fwd", "bwd", "update"]
            for x, y in zip(kids, kids[1:]):
                assert x["start_ms"] < x["end_ms"] <= y["start_ms"]
            assert 0.0 <= kids[0]["start_ms"] and kids[-1]["end_ms"] <= step_["end_ms"]
            assert all(s["end_ms"] > s["start_ms"] for s in _named(spans, "bwd.unit"))

    def test_events_resolve_only_after_their_step(self, card, monkeypatch):
        cfg = _card_cfg()
        params = S.init_params(cfg, seed=0, device=card)
        step, state = _ddp_step(cfg, params)
        b = _batch(cfg, rows=1, seq=4096, device=card)
        queried = []
        with tracing.record(card) as rec:
            params, state, m = step(params, state, b)
            assert rec.resolved == 0 and len(rec._pending) == 1
            float(m["loss"])
            with monkeypatch.context() as mp:
                mp.setattr(torch.cuda, "synchronize", lambda *a: queried.append("sync"))
                params, state, m = step(params, state, b)
            assert queried == [] and rec.resolved == 1
            rec.summary()
        assert rec.resolved == 2 and not rec._pending

    def test_the_tracer_adds_no_device_work(self, card):
        from torch.profiler import ProfilerActivity, profile

        cfg = _card_cfg()
        params = S.init_params(cfg, seed=0, device=card)
        step, state = _ddp_step(cfg, params)
        b = _batch(cfg, rows=1, seq=4096, device=card)
        for _ in range(2):
            params, state, m = step(params, state, b)
            float(m["loss"])
        cuda = torch.autograd.DeviceType.CUDA

        def busy(on):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with tracing.record(card) if on else tracing._OFF:
                    nonlocal params, state
                    for _ in range(3):
                        params, state, m = step(params, state, b)
                        float(m["loss"])
            dev = sorted((e.time_range.start, e.time_range.end, e.name)
                         for e in prof.events() if e.device_type == cuda)
            total, hi = 0.0, float("-inf")
            for a, z, _ in dev:
                total += max(0.0, z - max(a, hi))
                hi = max(hi, z)
            return total, {n for _, _, n in dev}

        runs = {False: [], True: []}
        names = {False: set(), True: set()}
        for on in (False, True, True, False):
            t, n = busy(on)
            runs[on].append(t)
            names[on] |= n
        off, on = sum(runs[False]) / 2, sum(runs[True]) / 2
        assert abs(on - off) <= 0.03 * off, (runs, off, on)
        assert names[True] == names[False]
        program = {"step", "fwd", "bwd", "update", "fwd.embed", "fwd.unit", "fwd.head",
                   "fwd.loss", "bwd.head", "bwd.unit", "bwd.embed", "bwd.loss"}
        assert not program & names[True]
