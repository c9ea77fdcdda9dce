"""The port's trace generator (``repro_torch.traces.generate``) against the
reference's (``repro.traces.generate``), on the CPU.

Twins of ``tests/test_traces.py::TestGenerator``, then both generators on
the same bridged CNN layers (``repro_torch.models.cnn.from_reference``):
ids, names, gradient bytes and the Comm. column (the K80 cluster's
16-GPU all-reduce of those bytes) are ``==``; times are this host's and
are only required positive where the reference's are.  The generated file
reads back through both packages' ``read_trace``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.hardware import K80_CLUSTER as J_K80
from repro.models import cnn as jcnn
from repro.traces import format as jformat
from repro.traces import generate as jgenerate
from repro_torch.core.hardware import K80_CLUSTER as T_K80
from repro_torch.models import cnn as tcnn
from repro_torch.traces import format as tformat
from repro_torch.traces import generate as tgenerate
from repro_torch.traces.generate import TimedLayer, generate_trace


class TestGenerator:
    def test_generate_matches_structure(self):
        W1 = torch.randn((16, 32), generator=torch.Generator().manual_seed(0))
        layers = [TimedLayer("fc1", lambda p, x: torch.tanh(x @ p), W1),
                  TimedLayer("act", lambda p, x: torch.relu(x), {})]
        tr = generate_trace(layers, torch.ones((4, 16)), "tiny",
                            n_iterations=2, repeats=2)
        mean = tr.mean_iteration()
        assert [r.name for r in mean] == ["fc1", "act"]
        assert mean[0].size_bytes == 16 * 32 * 4
        assert mean[1].size_bytes == 0          # non-learnable
        assert mean[1].backward_us == 0.0
        assert all(r.forward_us > 0 for r in mean)
        assert mean[0].backward_us > 0
        assert len(tr.iterations) == 2 and tr.cluster == "cpu-host"

    def test_comm_time_fn(self):
        layers = [TimedLayer("fc", lambda p, x: x @ p,
                             torch.randn((8, 8), generator=torch.Generator().manual_seed(0)))]
        tr = generate_trace(layers, torch.ones((2, 8)), "tiny",
                            n_iterations=1, repeats=1,
                            comm_time_fn=lambda b: b * 1e-6)
        rec = tr.mean_iteration()[0]
        assert rec.comm_us == pytest.approx(rec.size_bytes)


def _record_grad_inputs(monkeypatch) -> list:
    """The number of tensors each ``torch.autograd.grad`` call of the
    generator differentiates."""
    seen = []
    real = torch.autograd.grad

    def grad(outputs, inputs, *a, **kw):
        seen.append(len(inputs))
        return real(outputs, inputs, *a, **kw)

    monkeypatch.setattr(tgenerate.torch.autograd, "grad", grad)
    return seen


def test_integer_input_differentiates_only_the_parameters(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    emb = torch.randn((50, 8), generator=gen)
    w = {"w": torch.randn((8, 4), generator=gen), "b": torch.zeros(4)}
    layers = [TimedLayer("embed", lambda p, t: p[t], emb),
              TimedLayer("fc", lambda p, x: x @ p["w"] + p["b"], w)]
    seen = _record_grad_inputs(monkeypatch)
    tokens = torch.randint(0, 50, (2, 5), generator=gen)
    tr = generate_trace(layers, tokens, "lm", n_iterations=1, repeats=2)
    # warm-up + 2 repeats each: the embedding's table alone, then fc's two
    # parameters and its float input
    assert seen == [1] * 3 + [3] * 3
    mean = tr.mean_iteration()
    assert [r.size_bytes for r in mean] == [50 * 8 * 4, (8 * 4 + 4) * 4]
    assert all(r.backward_us > 0 for r in mean)


def test_tf32_is_off_while_timing_and_restored():
    seen = []

    def apply(p, x):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return x @ p

    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        generate_trace([TimedLayer("fc", apply, torch.ones((3, 3)))], torch.ones((2, 3)),
                       "t", n_iterations=1, repeats=1)
        assert seen and set(seen) == {(False, False)}
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == \
            (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def test_layer_errors_finds_the_layer_that_differs():
    """``layer_errors`` on the CPU against itself: 0; with one parameter of
    one layer moved, that layer's tensors differ (the output, then the
    gradient in the input), measured against max(1, max |reference|)."""
    from repro_torch.examples.table6_trace import reduced_networks
    from repro_torch.traces.generate import layer_errors

    build, batch = reduced_networks(torch.device("cpu"))["resnet50"]
    layers, x0 = build()
    x = torch.randn((batch,) + tuple(x0.shape[1:]), generator=torch.Generator().manual_seed(1))
    x = x.contiguous(memory_format=torch.channels_last)
    assert layer_errors(layers, layers, x)[0] == 0.0
    moved = list(layers)
    w = moved[2].params["c1"]["w"].clone()
    w[0, 0, 0, 0] += 0.5
    moved[2] = dataclasses.replace(moved[2], params={**moved[2].params,
                                                     "c1": {**moved[2].params["c1"], "w": w}})
    worst, where = layer_errors(layers, moved, x)
    assert worst > 1e-3 and where.startswith(layers[2].name + " ")


@pytest.mark.parametrize("on", [False, True])
def test_layer_errors_sets_tf32_and_restores(on):
    seen = []

    def apply(p, x):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return x @ p

    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    layers = [TimedLayer("fc", apply, torch.ones((3, 3)))]
    tgenerate.layer_errors(layers, layers, torch.ones((2, 3)), tf32_on=on)
    assert seen and set(seen) == {(on, on)}
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before


@pytest.fixture(scope="module")
def both_alexnets():
    """(reference trace, port trace) of the bridged AlexNet at 99 x 99,
    batch 2, one iteration of one repeat, comm priced by the K80 cluster."""
    jlayers, jx = jcnn.alexnet_timed_layers(jax.random.PRNGKey(0), input_hw=99)
    tlayers, tx = tcnn.alexnet_timed_layers(0, input_hw=99, device="cpu")
    params = tcnn.from_reference([jax.tree_util.tree_map(np.asarray, l.params)
                                  for l in jlayers])
    tlayers = [dataclasses.replace(l, params=p) for l, p in zip(tlayers, params)]
    x = np.random.default_rng(5).standard_normal((2, 99, 99, 3)).astype(np.float32)
    j = jgenerate.generate_trace(jlayers, jax.numpy.asarray(x), "alexnet-99",
                                 n_iterations=1, repeats=1,
                                 comm_time_fn=lambda b: J_K80.allreduce_time(b, 16))
    t = generate_trace(tlayers, torch.from_numpy(x).permute(0, 3, 1, 2)
                       .contiguous(memory_format=torch.channels_last), "alexnet-99",
                       n_iterations=1, repeats=1,
                       comm_time_fn=lambda b: T_K80.allreduce_time(b, 16))
    return j, t


def test_ids_names_bytes_and_comm_equal_reference(both_alexnets):
    j, t = both_alexnets
    key = lambda r: (r.layer_id, r.name, r.size_bytes, r.comm_us)  # noqa: E731
    assert [key(r) for r in t.mean_iteration()] == [key(r) for r in j.mean_iteration()]
    assert (t.network, t.cluster, len(t.iterations)) == (j.network, j.cluster, 1)
    for tr, jr in zip(t.mean_iteration(), j.mean_iteration()):
        assert tr.forward_us > 0
        assert (tr.backward_us > 0) == (jr.backward_us > 0), tr.name


def test_generated_file_reads_back_in_both_packages(both_alexnets, tmp_path):
    _, t = both_alexnets
    path = tmp_path / "alexnet-99.trace"
    tformat.write_trace(t, path)
    back, ref = tformat.read_trace(path), jformat.read_trace(path)
    assert back == t
    assert dataclasses.asdict(back) == dataclasses.asdict(ref)
    assert dataclasses.asdict(back.to_iteration_costs()) == \
        dataclasses.asdict(ref.to_iteration_costs())
