"""The port's shape-only dry run against the reference, on the CPU.

The copies are held ``==`` to the reference: ``SHAPES``,
``LONG_CONTEXT_ARCHS`` and ``dryrun_matrix()``, ``archcost.step_cost`` for
all 33 pairs, and ``steps.params_shape`` / ``input_specs`` against the
reference's ``jax.eval_shape`` trees (key paths, shapes, dtypes) for all ten
archs at their published widths and every shape kind.  The lowering
(``repro_torch.launch.dryrun``) runs at one unit of each arch's published
widths on fake tensors of the meta device (this torch has no CUDA):
every pair lowers at dp1, and at dp2, where a sequence-sharded decode
cache takes the sequence-sharded decode; each arch's kernel operators are called, and nothing is
launched or loaded; at ``prefill_32k`` no (B, H, S, S) score tensor
exists and the temporaries stay under one; at dp2 the collectives are the
gradients' bytes exactly.
"""
import dataclasses

import jax
import pytest
import torch

from repro.configs import LONG_CONTEXT_ARCHS as JLONG
from repro.configs import SHAPES as JSHAPES
from repro.configs import dryrun_matrix as jdryrun_matrix
from repro.configs import get_config as jax_get_config
from repro.core import archcost as jarchcost
from repro.launch import steps as jsteps
from repro_torch import kernels
from repro_torch.configs import LONG_CONTEXT_ARCHS, SHAPES, dryrun_matrix, get_config
from repro_torch.core import archcost as tarchcost
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as T

MATRIX = dryrun_matrix()
#: the kernel operators each block kind runs in a step that takes a gradient
#: (train) and in one that does not (prefill, decode: forward only)
KIND_KERNELS = {"G": ("flash_fwd", "flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkdv"),
                "L": ("flash_fwd", "flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkdv"),
                "C": ("flash_fwd", "flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkdv"),
                "R": ("rglru_fwd", "rglru_bwd"), "W": ("wkv6_fwd", "wkv6_bwd")}


def _ref_tree(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            (tuple(leaf.shape), str(leaf.dtype)) for path, leaf in leaves}


def _port_tree(tree) -> dict:
    return {path: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for path, t in T.leaf_order(tree)}


def _expected_kernels(arch: str, shape: str) -> set[str]:
    cfg, kind = get_config(arch), SHAPES[shape].kind
    names = set()
    for k in cfg.layer_pattern:
        names |= set(KIND_KERNELS[k] if kind == "train" else KIND_KERNELS[k][:1])
    if kind == "decode":       # decode attention is plain torch; the C blocks'
        names -= {"flash_fwd"}  # cross-attention at one token is the kernel's
        if "C" in cfg.layer_pattern:
            names.add("flash_fwd")
    return names


def _one_unit(arch: str) -> int:
    return len(get_config(arch).layer_pattern)


def _cut(arch: str, num_layers: int):
    return dataclasses.replace(get_config(arch), num_layers=num_layers)


class TestCopies:
    def test_shapes_long_context_and_matrix_equal_reference(self):
        assert {k: vars(v) for k, v in SHAPES.items()} == \
            {k: vars(v) for k, v in JSHAPES.items()}
        assert LONG_CONTEXT_ARCHS == JLONG
        assert MATRIX == jdryrun_matrix() and len(MATRIX) == 33

    @pytest.mark.parametrize("arch,shape", MATRIX)
    def test_step_cost_equals_reference(self, arch, shape):
        got = tarchcost.step_cost(get_config(arch), SHAPES[shape])
        want = jarchcost.step_cost(jax_get_config(arch), JSHAPES[shape])
        assert vars(got) == vars(want)
        assert tarchcost._attention_flops_fwd(get_config(arch), 4096, 3) == \
            jarchcost._attention_flops_fwd(jax_get_config(arch), 4096, 3)

    @pytest.mark.parametrize("arch", [a for a, s in MATRIX if s == "train_4k"])
    def test_params_shape_and_input_specs_equal_reference(self, arch):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        params = tsteps.params_shape(cfg, device="meta")
        assert _port_tree(params) == _ref_tree(jsteps.params_shape(jcfg))
        assert all(t.device.type == "meta" and type(t).__name__ == "FakeTensor"
                   for _, t in T.leaf_order(params))
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            got = tsteps.input_specs(cfg, SHAPES[shape], device="meta")
            assert _port_tree(got) == _ref_tree(jsteps.input_specs(jcfg, JSHAPES[shape])), shape


class TestLowering:
    @pytest.mark.parametrize("arch,shape", MATRIX)
    def test_every_pair_lowers_at_one_unit_through_the_kernels(self, arch, shape):
        kernels.reset_launches()
        rec = dryrun.dryrun_one(arch, shape, num_layers=_one_unit(arch))
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["mesh"] == "dp1" and rec["device"] == "meta"
        assert set(rec["kernel_calls"]) == _expected_kernels(arch, shape)
        assert all(n == 0 for n in kernels.all_launches().values())
        assert all(mod._lib is None for mod in kernels.kernel_modules())
        assert not torch.cuda.is_initialized()
        mem, flops = rec["memory"], rec["cost_analysis"]["flops"]
        assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0 and flops > 0
        assert rec["collectives"]["total_bytes"] == 0
        assert rec["analytic"]["flops"] == tarchcost.step_cost(
            _cut(arch, _one_unit(arch)), SHAPES[shape]).flops

    @pytest.mark.parametrize("arch,shape", [
        ("qwen1.5-4b", "train_4k"), ("qwen1.5-4b", "prefill_32k"), ("qwen1.5-4b", "decode_32k"),
        ("whisper-tiny", "decode_32k"), ("rwkv6-1.6b", "long_500k"),
        ("gemma3-1b", "long_500k"), ("recurrentgemma-2b", "long_500k")])
    def test_dp2_lowers_unless_the_cache_is_sequence_sharded(self, arch, shape):
        """Every pair lowers at dp2.  Where the rules shard the cache's
        sequence axis (``long_500k`` at batch 1, but for rwkv6-1.6b, which
        keeps no kv cache), a rank holds half of every ``G`` and ``L`` cache
        and the sequence-sharded decode's combine is counted: three
        all-reduces of B·H·(hd + 2)·4 bytes a sharded layer."""
        rec = dryrun.dryrun_one(arch, shape, ranks=2, num_layers=_one_unit(arch))
        assert rec["status"] == "ok", rec.get("traceback")
        one = dryrun.dryrun_one(arch, shape, ranks=1, num_layers=_one_unit(arch))
        sharded = shape == "long_500k" and arch != "rwkv6-1.6b"
        halves = SHAPES[shape].global_batch % 2 == 0 or sharded
        # a batch (or a cache's sequence) that splits: half the batch and
        # cache, the same parameters
        assert (rec["memory"]["argument_bytes"] < one["memory"]["argument_bytes"]) == halves
        assert (rec["cost_analysis"]["flops"] < one["cost_analysis"]["flops"]) == halves
        if shape == "long_500k":
            cfg = get_config(arch)
            layers = sum(kind in "GL" for kind in cfg.layer_pattern) if sharded else 0
            assert rec["collectives"]["total_count"] == 3 * layers
            assert rec["collectives"]["total_bytes"] == \
                layers * cfg.num_heads * (cfg.head_size + 2) * 4

    @pytest.mark.parametrize("policy", ["at_end", "bucketed"])
    def test_dp2_collectives_are_the_gradients_bytes(self, policy):
        params = T.init_lm(_cut("qwen1.5-4b", 1), device="meta")
        rec = dryrun.dryrun_one("qwen1.5-4b", "train_4k", ranks=2, num_layers=1,
                                policy=policy)
        assert rec["status"] == "ok", rec.get("traceback")
        leaves = [t for _, t in T.leaf_order(params)]
        if policy == "at_end":    # every leaf in its own dtype
            want = sum(t.numel() * t.element_size() for t in leaves)
            assert rec["collectives"]["total_count"] == len(leaves)
        else:                     # float32 buckets
            want = sum(t.numel() * 4 for t in leaves)
        assert rec["collectives"]["total_bytes"] == want
        assert rec["collectives"]["bytes_by_op"] == {"all-reduce": want}
        assert rec["policy"] == policy

    def test_prefill_counts_the_kernels_memory_not_the_scores(self, monkeypatch):
        shp = SHAPES["prefill_32k"]
        cfg = get_config("qwen1.5-4b")
        score = (shp.global_batch, cfg.num_heads, shp.seq_len, shp.seq_len)
        shapes = []

        class Recording(dryrun.Lowering):
            def own(self, tree, count=False):
                shapes.extend(tuple(t.shape) for t in torch.utils._pytree.tree_leaves(tree)
                              if isinstance(t, torch.Tensor))
                super().own(tree, count)

        monkeypatch.setattr(dryrun, "Lowering", Recording)
        rec = dryrun.dryrun_one("qwen1.5-4b", "prefill_32k", num_layers=1)
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["kernel_calls"] == {"flash_fwd": 1}
        assert shapes and score not in shapes
        assert rec["memory"]["temp_bytes"] < 4 * torch.Size(score).numel()

    def test_remat_accumulation_and_unsupported_modes(self):
        base = dryrun.dryrun_one("rwkv6-1.6b", "train_4k", num_layers=1)
        no_remat = dryrun.dryrun_one("rwkv6-1.6b", "train_4k", num_layers=1, remat=False)
        accum = dryrun.dryrun_one("rwkv6-1.6b", "train_4k", num_layers=1, accum_steps=4)
        assert base["kernel_calls"] == {"wkv6_bwd": 1, "wkv6_fwd": 2}
        assert no_remat["kernel_calls"] == {"wkv6_bwd": 1, "wkv6_fwd": 1}
        assert accum["kernel_calls"] == {"wkv6_bwd": 4, "wkv6_fwd": 8}
        assert accum["memory"]["temp_bytes"] < base["memory"]["temp_bytes"]
        # fsdp, and pure_dp on a mesh with a model axis: tensor parallelism
        fsdp = dryrun.dryrun_one("rwkv6-1.6b", "train_4k", mode="fsdp")
        assert fsdp["status"] == "ok", fsdp.get("traceback")
        tp = dryrun.dryrun_one("rwkv6-1.6b", "train_4k", mesh={"data": 16, "model": 16})
        assert tp["status"] == "ok" and tp["mesh"] == "16x16", tp.get("traceback")
        assert tp["collectives"]["count_by_op"]["reduce-scatter"] > 0   # wv's, on model
        for mode in ("fsdp2d", "zero3"):     # on dp1 nothing is split: pure_dp's record
            rec = dryrun.dryrun_one("rwkv6-1.6b", "train_4k", mode=mode, num_layers=1)
            assert rec["status"] == "ok" and rec["memory"] == base["memory"]

    def test_cli_writes_the_record(self, tmp_path, capsys):
        assert dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "long_500k",
                            "--out-dir", str(tmp_path)]) == 0
        path = tmp_path / "rwkv6-1.6b__long_500k__dp1.json"
        import json

        rec = json.loads(path.read_text())
        for key in ("arch", "shape", "mesh", "mode", "remat", "accum_steps", "n_devices",
                    "status", "lower_s", "compile_s", "memory", "cost_analysis",
                    "collectives", "analytic", "total_s"):
            assert key in rec
        assert rec["compile_s"] is None and rec["memory"]["generated_code_bytes"] is None
        assert rec["cost_analysis"]["while_body_counted_once"] is False
        assert dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "train_4k", "--mode", "fsdp",
                            "--out-dir", str(tmp_path)]) == 0
        rec = json.loads((tmp_path / "rwkv6-1.6b__train_4k__dp1__fsdp.json").read_text())
        assert rec["status"] == "ok" and rec["mode"] == "fsdp"
