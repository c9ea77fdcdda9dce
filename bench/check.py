"""What decides ``correct``: the program's first steps against the plain
reference following the same steps from the same parameters and batches.

Three numbers are compared, each with its limit (``bench/limits/<cell>.json``):

* ``loss``: the largest relative gap of a step's loss over the followed steps;
* ``grad``: the first gradient, as the optimizer holds it after step 1
  (momentum from zero is the gradient), by the worst leaf: the gap between
  the program's norm and the reference's, over the reference's norm of that
  leaf or of the median leaf, whichever is larger;
* ``change``: the parameters' change over the followed steps, by the worst
  leaf the same way; leaves whose reference gradient is under a thousandth
  of the median leaf's are left out, since round-off alone moves them.

A leaf here is one layer's slice of a stacked ``units`` leaf, or a whole
unstacked leaf."""
from __future__ import annotations

import math
import statistics

import torch

from bench.reference.common import MATMULS
from bench.weights import draw

#: leaves whose reference gradient is under this share of the median
#: leaf's are left out of ``change``
QUIET_GRAD = 1e-3


def leaf_slices(flat: dict[tuple, torch.Tensor]):
    """(name, tensor) for every leaf: one per layer of a stacked leaf."""
    for path, t in flat.items():
        name = "/".join(path)
        if path[0] == "units":
            for u in range(t.shape[0]):
                yield f"{name}[{u}]", t[u]
        else:
            yield name, t


@torch.no_grad()
def norms(flat: dict[tuple, torch.Tensor]) -> dict[str, float]:
    """Each leaf's float32 norm."""
    vals = {n: torch.linalg.vector_norm(t.float()) for n, t in leaf_slices(flat)}
    host = torch.stack(list(vals.values())).tolist()
    return dict(zip(vals, host))


@torch.no_grad()
def change_norms(now: dict[tuple, torch.Tensor], start: dict[tuple, torch.Tensor]):
    """Each leaf's norm of ``now - start`` in float32."""
    before = dict(leaf_slices(start))
    vals = {n: torch.linalg.vector_norm(a.float() - before[n].float())
            for n, a in leaf_slices(now)}
    host = torch.stack(list(vals.values())).tolist()
    return dict(zip(vals, host))


def _by_worst_leaf(prog: dict, ref: dict, keep) -> float:
    names = [n for n in ref if keep(n)]
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def gaps(prog: dict, ref: dict) -> dict[str, float]:
    """The three numbers from two sets of readings (``loss``: a list per
    step; ``grad`` and ``change``: leaf -> norm)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    med = statistics.median(ref["grad"].values())
    moved = {n for n, g in ref["grad"].items() if g >= QUIET_GRAD * med}
    out = {"loss": loss,
           "grad": _by_worst_leaf(prog["grad"], ref["grad"], lambda n: True),
           "change": _by_worst_leaf(prog["change"], ref["change"], lambda n: n in moved)}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def _per_layer(flat: dict[tuple, torch.Tensor], L: int, dtype=torch.float32) -> dict:
    """The reference's tree: copies in ``dtype``, stacked leaves split into
    lists of one leaf per layer, each requiring its gradient."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if path[0] == "units":
            node[path[-1]] = [t[u].to(dtype, copy=True).requires_grad_() for u in range(L)]
        else:
            node[path[-1]] = t.to(dtype, copy=True).requires_grad_()
    return tree


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for u, t in enumerate(tree):
            yield "/".join(prefix) + f"[{u}]", t
    else:
        yield "/".join(prefix), tree


def follow(family, c: dict, seed: int, batches: list[dict], lr: float, momentum: float,
           device, matmul: str = "f32", store=None, fault: str | None = None,
           dtype=torch.float32) -> dict:
    """The reference's readings over ``batches`` (one step each) from the
    parameters ``seed`` draws: SGD with momentum in float32, each step's loss
    and gradient summed sequence by sequence, each leaf's gradient added to
    its momentum as it is made.  ``matmul`` "fp8" and ``store`` a dtype (the
    parameters rounded to it after each update) make the control.
    ``fault`` plants one in the steps: "half_batch" takes the mean over the
    first half of the rows (of the tokens, for one row).  ``dtype`` float64
    gives a witness of the float32 reference itself."""
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        start = draw(family.layout(c), seed, device)
        params = _per_layer(start, c["num_layers"], dtype)
        leaves = dict(_leaves(params))
        mom = {n: torch.zeros_like(t) for n, t in leaves.items()}

        def add_to_momentum(name):
            def hook(t):
                mom[name].add_(t.grad)
                t.grad = None
            return hook

        handles = [t.register_post_accumulate_grad_hook(add_to_momentum(n))
                   for n, t in leaves.items()]
        mm = MATMULS[matmul]
        out: dict = {"loss": []}
        for i, batch in enumerate(batches):
            tokens = torch.as_tensor(batch["tokens"], device=device).long()
            labels = torch.as_tensor(batch["labels"], device=device).long()
            if fault == "half_batch":
                if tokens.shape[0] > 1:
                    tokens, labels = tokens[:tokens.shape[0] // 2], labels[:labels.shape[0] // 2]
                else:
                    tokens, labels = tokens[:, :tokens.shape[1] // 2], labels[:, :labels.shape[1] // 2]
            n_tok = tokens.numel()
            with torch.no_grad():
                for m in mom.values():
                    m.mul_(momentum)
            total = 0.0
            for row in range(tokens.shape[0]):
                loss = family.row_loss(c, params, tokens[row], labels[row], mm) / n_tok
                loss.backward()
                total += loss.item()
            out["loss"].append(total)
            if i == 0:
                out["grad"] = {n: torch.linalg.vector_norm(m).item() for n, m in mom.items()}
            with torch.no_grad():
                for n, t in leaves.items():
                    t.sub_(lr * mom[n])
                    if store is not None:
                        t.copy_(t.to(store))
        for h in handles:
            h.remove()
        with torch.no_grad():
            out["change"] = {n: torch.linalg.vector_norm(leaves[n] - s.to(dtype)).item()
                             for n, s in leaf_slices(start)}
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev_tf32
