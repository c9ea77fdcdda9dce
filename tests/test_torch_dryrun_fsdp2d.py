"""The dry run's ``fsdp2d`` mode on the reference's ``2x16x16`` mesh
(512 fake ranks), on the CPU: every pair of ``dryrun_matrix()``
lowered at one unit of its published widths on meta fake tensors, its
arguments and its collectives by op held to counts made from the sharding
specs alone (``tests/_dryrun_modes.py``), ``long_500k``'s combine over the
16 ranks of the ``data`` axis.  No kernel is launched or loaded.
"""
import pytest
from _dryrun_modes import MATRIX, check_pair


@pytest.mark.parametrize("arch,shape", MATRIX)
def test_every_pair_lowers_fsdp2d_on_2_16_16(arch, shape, monkeypatch):
    check_pair(arch, shape, "2x16x16", "fsdp2d", monkeypatch)


def test_roofline_renders_the_modes(tmp_path, monkeypatch):
    """``launch.roofline`` reads the records of several meshes and modes:
    one roofline table for each, the note under fsdp2d's, and train_4k by
    mesh and mode with its lowered / analytic FLOPs."""
    import json

    from repro_torch.launch import dryrun, roofline

    for mesh, mode in (("2x16x16", "fsdp2d"), ("16x16", "zero3")):
        rec = check_pair("rwkv6-1.6b", "train_4k", mesh, mode, monkeypatch)
        dryrun.result_path("rwkv6-1.6b", "train_4k", mesh, tmp_path, mode).write_text(
            json.dumps(rec))
    rec = dryrun.dryrun_one("rwkv6-1.6b", "train_4k", ranks=8, num_layers=1)
    dryrun.result_path("rwkv6-1.6b", "train_4k", "dp8", tmp_path).write_text(json.dumps(rec))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "rwkv6-1.6b__train_4k__16x16__zero3.json", "rwkv6-1.6b__train_4k__2x16x16__fsdp2d.json",
        "rwkv6-1.6b__train_4k__dp8.json"]
    out = tmp_path / "roofline.md"
    roofline.main(["--results-dir", str(tmp_path), "--write", "--out", str(out)])
    text = out.read_text()
    for head in ("# Roofline (dp8: 8 x", "# Roofline (16x16, zero3: 256 x",
                 "# Roofline (2x16x16, fsdp2d: 512 x", "# train_4k by mesh and mode"):
        assert head in text, head
    assert text.index("dp8: 8") < text.index("16x16, zero3") < text.index("2x16x16, fsdp2d")
    assert "counts a rank's work short by the model axis' size" in text
    rows = [ln for ln in text.splitlines() if ln.startswith("| rwkv6-1.6b | 2x16x16 | fsdp2d |")]
    assert len(rows) == 1 and rows[0].endswith("| yes |")
