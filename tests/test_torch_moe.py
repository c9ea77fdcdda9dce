"""The port's MoE MLP (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``), on the CPU in float32.

Parameters are initialised by the reference and carried over with
``from_reference``; inputs and cotangents are drawn with numpy from a seed.
Cases: qwen2-moe-a2.7b reduced to 8 experts (top-4, with the shared
experts), grok-1-314b reduced to 8 experts (top-2, no shared) and at top-1
(the aux loss's ``k == 1`` branch); a token count that is a multiple of the
group size (64) and one that is not (the last group padded with zero
tokens, whose uniform router probabilities tie); and a capacity factor of
0.5, at which tokens are dropped.

Tolerances: the routing (each token's experts in order, the capacity keep
mask) equal; the output within 2e-4 of its scale; the aux loss within rel
1e-5; the input's and every parameter's gradient within 2e-5 of its scale
(``tests/test_torch_model.py``'s ``GRAD_TOL``): both sides sum the same
float32 terms in different orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT

GRAD_TOL = 2e-5
#: case -> (arch, config overrides beyond the 8 experts)
CASES = {
    "qwen2moe": ("qwen2-moe-a2.7b", {}),
    "grok": ("grok-1-314b", {}),
    "grok_top1": ("grok-1-314b", {"experts_per_token": 1}),
    "qwen2moe_low_capacity": ("qwen2-moe-a2.7b", {"capacity_factor": 0.5}),
    "grok_low_capacity": ("grok-1-314b", {"capacity_factor": 0.5}),
}
#: sequence lengths at batch 2: 128 tokens (two whole groups of 64) and 90
#: (a group of 64 and one of 26 padded with 38 zero tokens)
SEQS = (64, 45)


def _configs(case):
    arch, over = CASES[case]
    over = dict(num_experts=8, **over)
    return (jax_get_config(arch).reduced(**over), torch_get_config(arch).reduced(**over))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(k.key for k in p), np.asarray(leaf)) for p, leaf in flat]


def _reference_routing(jcfg, router, x):
    """The reference's routing lines (``repro/models/moe.py:55-75``): top_e
    and keep of the padded groups."""
    d, k = jcfg.d_model, jcfg.experts_per_token
    tokens = x.reshape(-1, d)
    g = min(jcfg.moe_group_size, tokens.shape[0])
    pad = (-tokens.shape[0]) % g
    tokens = jnp.concatenate([tokens, jnp.zeros((pad, d), tokens.dtype)])
    xg = tokens.reshape(-1, g, d)
    probs = jax.nn.softmax(jnp.einsum("Ggd,dE->GgE", xg, router), axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    flat = jax.nn.one_hot(top_e, jcfg.num_experts, dtype=jnp.int32).reshape(
        xg.shape[0], g * k, -1)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat) * flat, axis=-1).reshape(top_e.shape)
    return np.asarray(xg), np.asarray(top_e), np.asarray(pos < jmoe._capacity(jcfg, g))


class TestConfigs:
    @pytest.mark.parametrize("case", CASES)
    def test_reduced_configs_route(self, case):
        """8 experts, so top-k selects (the default ``reduced()`` gives
        qwen2-moe 4 experts at top-4: every token to every expert)."""
        jcfg, tcfg = _configs(case)
        assert tcfg.num_experts == jcfg.num_experts == 8
        assert tcfg.experts_per_token == jcfg.experts_per_token < 8
        assert bool(tcfg.shared_expert_d_ff) == case.startswith("qwen2moe")

    @pytest.mark.parametrize("group", [1, 26, 64, 512])
    @pytest.mark.parametrize("case", CASES)
    def test_capacity_equals_reference(self, case, group):
        jcfg, tcfg = _configs(case)
        assert tmoe._capacity(tcfg, group) == jmoe._capacity(jcfg, group)

    @pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "grok-1-314b"])
    def test_init_layout_equals_reference(self, arch):
        """Key paths, shapes and dtypes at the published widths (shapes
        only), the router in float32 in the bf16 model."""
        jcfg, tcfg = jax_get_config(arch), torch_get_config(arch)
        jshape = jax.eval_shape(lambda k: jmoe.init_moe(jcfg, k), jax.random.PRNGKey(0))
        jl = [(tuple(k.key for k in p), leaf) for p, leaf in
              jax.tree_util.tree_flatten_with_path(jshape)[0]]
        tl = list(TT.leaf_order(tmoe.init_moe(tcfg, None, "meta")))
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (path, j), (_, t) in zip(jl, tl):
            assert tuple(j.shape) == tuple(t.shape), path
            assert str(j.dtype) == str(t.dtype).removeprefix("torch."), path
        assert dict(tl)[("router",)].dtype == torch.float32
        lead = tmoe.init_moe(tcfg, None, "meta", (3,))
        assert tuple(lead["wi"].shape) == (3, *dict(tl)[("wi",)].shape)


def _both_sides(case, S, seed=0, out_cotangent=True):
    """The reference's and the port's (out, aux) and the gradients of
    <out, ct> + ct_aux * aux with respect to x and every parameter leaf,
    from the same parameters and numpy draws: ``(routing, reference,
    port)``, each side a dict of numpy arrays keyed ``out``, ``aux`` and
    the gradients' key paths (``("x",)`` for the input)."""
    jcfg, tcfg = _configs(case)
    tree = jax.tree_util.tree_map(np.asarray, jmoe.init_moe(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32) * out_cotangent
    ct_aux = np.float32(rng.standard_normal())

    xg, top_e, keep = _reference_routing(jcfg, jnp.asarray(tree["router"]), jnp.asarray(x))
    _, _, t_onehot, _, t_keep = tmoe.route(tcfg, torch.tensor(tree["router"]),
                                           torch.tensor(xg))
    routing = {"top_e": (top_e, t_onehot.argmax(-1).numpy()), "keep": (keep, t_keep.numpy()),
               "real_keep": keep.reshape(-1, keep.shape[-1])[: 2 * S]}

    (jout, jaux), vjp = jax.vjp(lambda p, a: jmoe.moe_mlp(jcfg, p, a),
                                jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(ct), jnp.asarray(ct_aux)))
    want = {"out": np.asarray(jout), "aux": np.asarray(jaux), **dict(_jax_leaves(jgp)),
            ("x",): np.asarray(jgx)}

    params = TT.from_reference(tree)
    paths, leaves = zip(*TT.leaf_order(params))
    tx = torch.from_numpy(x).requires_grad_()
    for leaf in leaves:
        leaf.requires_grad_(True)
    tout, taux = tmoe.moe_mlp(tcfg, params, tx)
    assert tout.dtype == torch.float32 and taux.dtype == torch.float32
    tgrads = torch.autograd.grad((tout, taux), (*leaves, tx),
                                 (torch.from_numpy(ct), torch.tensor(ct_aux)))
    got = {"out": _np(tout), "aux": _np(taux),
           **{path: _np(g) for path, g in zip((*paths, ("x",)), tgrads)}}
    assert [k for k in want if isinstance(k, tuple)] == [*paths, ("x",)]
    return routing, want, got


def _assert_grads_close(want, got, paths):
    for path in paths:
        w = want[path]
        assert np.abs(w).max() > 0, path
        assert np.abs(got[path] - w).max() <= GRAD_TOL * np.abs(w).max(), path


class TestMoeMlp:
    @pytest.mark.parametrize("S", SEQS)
    @pytest.mark.parametrize("case", [c for c in CASES if c != "grok_top1"])
    def test_routing_output_aux_and_gradients_match(self, case, S):
        routing, want, got = _both_sides(case, S)
        for name in ("top_e", "keep"):
            np.testing.assert_array_equal(*routing[name], err_msg=name)
        if "low_capacity" in case:
            assert not routing["real_keep"].all(), "a capacity factor of 0.5 drops no token"
        assert np.abs(got["out"] - want["out"]).max() <= 2e-4 * np.abs(want["out"]).max()
        assert float(got["aux"]) == pytest.approx(float(want["aux"]), rel=1e-5)
        assert (("shared", "wi") in want) == case.startswith("qwen2moe")
        _assert_grads_close(want, got, [k for k in want if isinstance(k, tuple)])

    @pytest.mark.parametrize("S", SEQS)
    def test_top1_matches(self, S):
        """At top-1 the renormalised gate v / v is exactly 1, so the router's
        and the input's gradient through it is 0 in exact arithmetic and the
        rounding of the quotient rule on either side; the experts' gradients
        are held with a random output cotangent, the router's and the
        input's through the aux loss (the ``k == 1`` branch) alone."""
        routing, want, got = _both_sides("grok_top1", S)
        for name in ("top_e", "keep"):
            np.testing.assert_array_equal(*routing[name], err_msg=name)
        assert np.abs(got["out"] - want["out"]).max() <= 2e-4 * np.abs(want["out"]).max()
        assert float(got["aux"]) == pytest.approx(float(want["aux"]), rel=1e-5)
        _assert_grads_close(want, got, [("wi",), ("wg",), ("wo",)])
        _, want, got = _both_sides("grok_top1", S, out_cotangent=False)
        _assert_grads_close(want, got, [("router",), ("x",)])

    def test_dropped_choices_add_nothing(self):
        """At capacity factor 0.5 a token whose every choice is dropped
        gets exactly the shared experts' output (here: no shared, so 0)."""
        _, tcfg = _configs("grok_low_capacity")
        params = tmoe.init_moe(tcfg, torch.Generator().manual_seed(0), "cpu")
        x = torch.randn(2, 64, tcfg.d_model, generator=torch.Generator().manual_seed(1))
        out, _ = tmoe.moe_mlp(tcfg, params, x)
        *_, keep = tmoe.route(tcfg, params["router"], x.reshape(2, 64, -1))
        dropped = ~keep.any(dim=-1)
        assert bool(dropped.any())
        assert bool((out.reshape(2, 64, -1)[dropped] == 0).all())

    def test_bf16_casts_follow_the_reference(self):
        """In a bf16 model the router and its probabilities stay float32 and
        the output is in the activations' dtype."""
        tcfg = dataclasses.replace(_configs("qwen2moe")[1], dtype=torch.bfloat16)
        params = tmoe.init_moe(tcfg, torch.Generator().manual_seed(0), "cpu")
        assert params["router"].dtype == torch.float32
        assert params["wi"].dtype == params["shared"]["wo"].dtype == torch.bfloat16
        x = torch.randn(1, 70, tcfg.d_model, generator=torch.Generator().manual_seed(2))
        out, aux = tmoe.moe_mlp(tcfg, params, x.to(torch.bfloat16))
        assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
        assert bool(torch.isfinite(out.float()).all())
