"""The dry run's tensor-parallel modes on the reference's production meshes,
on the CPU: ``fsdp`` (the reference's default) on ``16x16`` and
``2x16x16``, and ``pure_dp`` on ``16x16``.  Every pair of ``dryrun_matrix()``
lowered at one unit of its published widths on meta fake tensors, its
arguments held to the bytes of the specs alone and its collectives by op
to a count made from the layout (``tests/_dryrun_modes.py``: each block
family's collectives over ``model`` by which of its leaves' dims the rules
put there), ``decode_32k``'s combine over the 16 ranks of ``model``,
``long_500k``'s over the 16 of ``data`` with its scores summed over
``model`` (gemma3-1b and recurrentgemma-2b, whose one kv head leaves the
cache's head dim to ``model``).  No kernel is launched or loaded.
"""
import pytest
from _dryrun_modes import MATRIX, check_pair, one_unit

from repro_torch.configs import SHAPES
from repro_torch.launch.mesh import PRODUCTION_MESHES
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as T
from repro_torch.launch import steps as tsteps


@pytest.mark.parametrize("arch,shape", MATRIX)
def test_every_pair_lowers_fsdp_on_16_16(arch, shape, monkeypatch):
    check_pair(arch, shape, "16x16", "fsdp", monkeypatch)


@pytest.mark.parametrize("arch,shape", MATRIX)
def test_every_pair_lowers_fsdp_on_2_16_16(arch, shape, monkeypatch):
    check_pair(arch, shape, "2x16x16", "fsdp", monkeypatch)


@pytest.mark.parametrize("arch,shape", MATRIX)
def test_every_pair_lowers_pure_dp_on_16_16(arch, shape, monkeypatch):
    check_pair(arch, shape, "16x16", "pure_dp", monkeypatch)


@pytest.mark.parametrize("arch", ["gemma3-1b", "recurrentgemma-2b"])
def test_long_500k_sums_the_scores_over_model(arch, monkeypatch):
    """At batch 1 the cache's sequence takes ``data`` and, the one kv head
    not dividing ``model``, its head dim takes ``model``: each attention
    layer's scores are a sum over ``model`` of (1, H, S / 16) f32 partial
    dot products, one all-reduce beside the combine's three."""
    from repro_torch.models import attention as A

    sums = []
    partials = A._partials_hd_split

    def spy(q, k, v, valid, tp):
        sums.append((tp.size, tuple(k.shape)))
        return partials(q, k, v, valid, tp)

    monkeypatch.setattr(A, "_partials_hd_split", spy)
    rec = check_pair(arch, "long_500k", "16x16", "fsdp", monkeypatch)
    cfg, shape = one_unit(arch), SHAPES["long_500k"]
    sizes = PRODUCTION_MESHES["16x16"]
    cspecs = shd.cache_specs(tsteps.input_specs(cfg, shape, device="meta")["cache"],
                             shd.ShardingConfig(tuple(sizes), "fsdp"), sizes=sizes)
    kv = [s for p, s in T.leaf_order(cspecs) if p[-1] == "k"]
    assert kv and all(s[2:] == ("data", None, "model") for s in kv), kv
    layers = sum(k in "GL" for k in cfg.layer_pattern)
    assert len(sums) == layers
    assert all(size == 16 and k[-1] == cfg.head_size // 16 for size, k in sums), sums
    assert rec["collectives"]["count_by_op"]["all-reduce"] >= 4 * layers


def test_roofline_sets_the_tensor_parallel_modes_beside_the_others(tmp_path, monkeypatch):
    """``launch.roofline``: one table for each of fsdp on 16x16 and 2x16x16
    and pure_dp on 16x16 beside zero3's, and train_4k by mesh and mode with
    a row for each."""
    import json

    from repro_torch.launch import dryrun, roofline

    for mesh, mode in (("16x16", "fsdp"), ("2x16x16", "fsdp"), ("16x16", "pure_dp"),
                       ("16x16", "zero3")):
        rec = check_pair("rwkv6-1.6b", "train_4k", mesh, mode, monkeypatch)
        dryrun.result_path("rwkv6-1.6b", "train_4k", mesh, tmp_path, mode).write_text(
            json.dumps(rec))
    out = tmp_path / "roofline.md"
    roofline.main(["--results-dir", str(tmp_path), "--write", "--out", str(out)])
    text = out.read_text()
    for head in ("# Roofline (16x16: 256 x", "# Roofline (16x16, fsdp: 256 x",
                 "# Roofline (2x16x16, fsdp: 512 x", "# train_4k by mesh and mode"):
        assert head in text, head
    rows = [ln for ln in text.splitlines() if ln.startswith("| rwkv6-1.6b | ")
            and ln.count("|") == 12]
    assert [r.split("|")[2:4] for r in rows] == [
        [" 16x16 ", " fsdp "], [" 16x16 ", " pure_dp "], [" 16x16 ", " zero3 "],
        [" 2x16x16 ", " fsdp "]], rows
