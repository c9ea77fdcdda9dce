"""The port's CNNs (``repro_torch.models.cnn``) against the reference's
(``repro.models.cnn``), on the CPU.

The reference initialises each layer (``jax.random``) and the port's
bridge (``cnn.from_reference``: HWIO -> OIHW, fully connected unchanged)
carries the parameters over.  Inputs are numpy draws from a seed, given to
the reference as NHWC and to the port as NCHW in channels_last memory.
Each layer's forward and the gradient of its output's sum in the
parameters and the input (the trace generator's VJP) are held to the
reference's ``jax.jit(apply)`` and ``jax.grad`` at 2e-4 of each tensor's
scale (max(1, max |reference|)), the float32 limit of
``tests/test_kernels.py``'s ``_tol``.  Every layer gets the reference's
output of the layer before as its input.

The reduced sizes do not collapse anything: AlexNet at 99 has pool5 2 x 2
(fc6 1024 x 4096); ResNet at 64 with one block a stage hits XLA's
asymmetric ``SAME`` pads, (2, 3) in conv1 and (0, 1) in stage 4's and 5's
strided 3 x 3 convolutions.  At 224 the layer lists and per-layer
parameter bytes are held ``==`` to the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as jcnn
from repro.traces import generate as jgenerate
from repro_torch.models import cnn as tcnn
from repro_torch.traces import generate as tgenerate

TOL = 2e-4
BATCH = 2
NETS = {
    "alexnet": (lambda key: jcnn.alexnet_timed_layers(key, input_hw=99),
                lambda: tcnn.alexnet_timed_layers(0, input_hw=99, device="cpu"), 99),
    "resnet": (lambda key: jcnn.resnet_timed_layers(key, input_hw=64,
                                                    depth_per_stage=(1, 1, 1, 1), width=8),
               lambda: tcnn.resnet_timed_layers(0, input_hw=64, depth_per_stage=(1, 1, 1, 1),
                                                width=8, device="cpu"), 64),
}
N_LAYERS = {"alexnet": 11, "resnet": 7}


def _to_port(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW torch in channels_last memory (2-D unchanged)."""
    t = torch.from_numpy(np.array(x))
    return t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last) \
        if t.dim() == 4 else t


def _to_ref(t: torch.Tensor) -> np.ndarray:
    """Port layout -> the reference's: NCHW -> NHWC, OIHW -> HWIO."""
    t = t.detach()
    if t.dim() == 4 and t.shape[0] == BATCH:
        t = t.permute(0, 2, 3, 1)
    elif t.dim() == 4:
        t = t.permute(2, 3, 1, 0)
    return t.contiguous().numpy()


def _close(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= TOL * scale, what


@pytest.fixture(scope="module")
def bridged():
    """net -> (reference layers, port layers carrying the reference's
    parameters, the per-layer reference inputs as numpy)."""
    out = {}
    for net, (jbuild, tbuild, hw) in NETS.items():
        jlayers, _ = jbuild(jax.random.PRNGKey(0))
        tlayers, _ = tbuild()
        ref_params = [jax.tree_util.tree_map(np.asarray, l.params) for l in jlayers]
        tlayers = [dataclasses.replace(l, params=p)
                   for l, p in zip(tlayers, tcnn.from_reference(ref_params))]
        x = np.random.default_rng(11).standard_normal((BATCH, hw, hw, 3)).astype(np.float32)
        inputs = []
        for l in jlayers:
            inputs.append(x)
            x = np.asarray(jax.jit(l.apply)(l.params, jnp.asarray(x)))
        out[net] = (jlayers, tlayers, inputs)
    return out


@pytest.mark.parametrize("net,lid", [(n, i) for n in NETS for i in range(N_LAYERS[n])])
def test_layer_forward_and_vjp_match_reference(bridged, net, lid):
    jlayers, tlayers, inputs = bridged[net]
    jl, tl, x = jlayers[lid], tlayers[lid], inputs[lid]
    assert tl.name == jl.name
    want = np.asarray(jax.jit(jl.apply)(jl.params, jnp.asarray(x)))
    with torch.no_grad():
        got = tl.apply(tl.params, _to_port(x))
    _close(_to_ref(got), want, f"{net} {jl.name} forward")

    argnums = (0, 1) if jax.tree_util.tree_leaves(jl.params) else (1,)
    jgrads = jax.grad(lambda p, xx: jnp.sum(jl.apply(p, xx)), argnums=argnums)(
        jl.params, jnp.asarray(x))
    jflat = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    tparams = jax.tree_util.tree_map(lambda t: t.detach().requires_grad_(True), tl.params)
    xt = _to_port(x).requires_grad_(True)
    leaves = jax.tree_util.tree_leaves(tparams)
    tgrads = torch.autograd.grad(tl.apply(tparams, xt).sum(), leaves + [xt])
    assert len(tgrads) == len(jflat)
    # jax's leaves are in sorted key order, as are the port's dicts here
    for k, (tg, jg) in enumerate(zip(tgrads, jflat)):
        _close(_to_ref(tg), jg, f"{net} {jl.name} gradient {k}")


def test_bridged_input_layout_is_channels_last(bridged):
    _, tlayers, inputs = bridged["resnet"]
    w = tlayers[0].params["w"]
    assert w.shape == (8, 3, 7, 7) and w.is_contiguous(memory_format=torch.channels_last)
    assert _to_port(inputs[0]).is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("size,k,stride,pads", [
    (224, 7, 2, (2, 3)), (55, 3, 2, (1, 1)), (28, 3, 2, (0, 1)), (14, 3, 2, (0, 1)),
    (64, 7, 2, (2, 3)), (8, 3, 2, (0, 1)), (4, 3, 2, (0, 1)), (26, 5, 1, (2, 2)),
    (56, 1, 2, (0, 0)), (12, 3, 1, (1, 1))])
def test_same_padding_is_xla_s(size, k, stride, pads):
    assert tcnn._same_pads(size, k, stride) == pads
    got = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]
    assert tuple(got) == pads


def _param_bytes(tree) -> list:
    return sorted(float(np.prod(l.shape)) * l.dtype.itemsize
                  for l in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("net,n_layers,total", [("alexnet", 11, 203_376_032),
                                                ("resnet", 19, 102_121_888)])
def test_full_size_layers_and_bytes_equal_reference(net, n_layers, total):
    """At 224: the names, the count and every layer's parameter bytes."""
    jbuild = jcnn.alexnet_timed_layers if net == "alexnet" else jcnn.resnet_timed_layers
    tbuild = tcnn.alexnet_timed_layers if net == "alexnet" else tcnn.resnet_timed_layers
    jlayers, _ = jbuild(jax.random.PRNGKey(0))
    tlayers, x0 = tbuild(0, device="cpu")
    assert [l.name for l in tlayers] == [l.name for l in jlayers] and len(jlayers) == n_layers
    for tl, jl in zip(tlayers, jlayers):
        assert tgenerate._param_bytes(tl.params) == jgenerate._param_bytes(jl.params), tl.name
        assert sorted(float(t.numel() * t.element_size())
                      for t in tgenerate._leaves(tl.params)) == _param_bytes(jl.params), tl.name
    assert sum(tgenerate._param_bytes(l.params) for l in tlayers) == total
    assert tuple(x0.shape) == (1, 3, 224, 224)


def test_fc6_width_follows_pool5():
    layers, _ = tcnn.alexnet_timed_layers(0, input_hw=99, device="cpu")
    assert tuple(layers[8].params["w"].shape) == (1024, 4096)
    with pytest.raises(ValueError, match="pool5 empty"):
        tcnn.alexnet_timed_layers(0, input_hw=64, device="cpu")


def test_a_seed_gives_the_same_weights():
    a, _ = tcnn.resnet_timed_layers(3, input_hw=32, depth_per_stage=(1,), width=4,
                                    device="cpu")
    b, _ = tcnn.resnet_timed_layers(torch.Generator().manual_seed(3), input_hw=32,
                                    depth_per_stage=(1,), width=4, device="cpu")
    for la, lb in zip(a, b):
        for ta, tb in zip(jax.tree_util.tree_leaves(la.params),
                          jax.tree_util.tree_leaves(lb.params)):
            assert torch.equal(ta, tb)
