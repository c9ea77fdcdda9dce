"""The plain references against the program's CPU path at tiny widths, in
float32, on the same seeded parameters and batch: the loss, every
gradient, and the parameters after one SGD step.  (The test may import the
program; the references do not.)"""
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from bench import check, harness
from bench.reference import dense_gqa, rwkv6
from bench.weights import batches, draw, nest

CONFIGS = Path(__file__).resolve().parent / "configs"
TINY = {"internlm2-20b": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                              d_ff=96, vocab_size=256),
        "rwkv6-1.6b": dict(num_layers=2, d_model=128, num_heads=2, d_ff=160, vocab_size=256)}


def tiny(name, dtype="float32"):
    c = json.loads((CONFIGS / f"{name}.json").read_text())
    c.update(TINY[name], dtype=dtype)
    return c


@pytest.mark.parametrize("name", sorted(TINY))
def test_reference_follows_the_program_on_the_cpu(name):
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.optim.sgd import sgd

    c = tiny(name)
    fam = harness.family(c)
    flat = draw(fam.layout(c), 5, "cpu")
    b = next(batches(5, c["vocab_size"], 2, 48))
    tokens, labels = torch.as_tensor(b["tokens"]).long(), torch.as_tensor(b["labels"]).long()
    cfg = harness.program_config(c)
    params = nest({k: v.clone() for k, v in flat.items()})
    loss, _, grads = loss_and_grads(cfg, params, tokens, labels)

    ref = check._per_layer(flat, c["num_layers"])
    ref_loss = sum(fam.row_loss(c, ref, tokens[r], labels[r], torch.matmul) / tokens.numel()
                   for r in range(2))
    ref_loss.backward()
    assert loss.item() == pytest.approx(ref_loss.item(), rel=1e-6)
    ref_leaves = dict(check._leaves(ref))
    for n, g in check.leaf_slices(harness.flatten(grads)):
        want = ref_leaves[n].grad
        assert torch.allclose(g, want, rtol=1e-4, atol=2e-5 * want.abs().max().item()), n

    opt = sgd(0.5, momentum=0.9)
    params, _ = opt.update(grads, opt.init(params), params)
    for n, p in check.leaf_slices(harness.flatten(params)):
        want = ref_leaves[n].detach() - 0.5 * ref_leaves[n].grad
        assert torch.allclose(p, want, rtol=1e-5, atol=1e-6), n


def test_chunked_wkv_is_the_step_scan_at_any_decay():
    g = torch.Generator().manual_seed(0)
    S, H, hd = 45, 2, 8                         # not a multiple of the chunk
    r, k, v = (torch.randn(S, H, hd, generator=g) for _ in range(3))
    logw = -torch.exp(3 * torch.randn(S, H, hd, generator=g))   # decays down to e^-8000
    u = torch.randn(H, hd, generator=g)
    st = torch.zeros(H, hd, hd, dtype=torch.float64)
    want = []
    for t in range(S):                          # the step recurrence in float64
        kv = k[t].double()[:, :, None] * v[t].double()[:, None, :]
        want.append(torch.einsum("hk,hkv->hv", r[t].double(), st + u.double()[:, :, None] * kv))
        st = logw[t].double().exp()[:, :, None] * st + kv
    got = rwkv6.wkv(r, k, v, logw, u)
    assert torch.allclose(got.double(), torch.stack(want), rtol=1e-4, atol=1e-5)


def test_blocked_attention_is_the_plain_one():
    from repro_torch.kernels.ref import attention

    g = torch.Generator().manual_seed(1)
    S, H, K, hd = 1100, 4, 2, 16                 # three blocks, the last ragged
    q = torch.randn(S, H, hd, generator=g)
    k, v = (torch.randn(S, K, hd, generator=g) for _ in range(2))
    got = dense_gqa.causal_attention(q, k, v, torch.matmul)
    want = attention(q[None], k[None], v[None])[0]
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)


def test_layouts_are_the_programs_trees():
    for name in TINY:
        for dtype in ("float32", "bfloat16"):
            c = tiny(name, dtype)
            harness.check_layout(harness.program_config(c), harness.family(c).layout(c))
    c = json.loads((CONFIGS / "internlm2-20b.json").read_text())
    harness.check_layout(dataclasses.replace(harness.program_config(c)),
                         harness.family(c).layout(c))
