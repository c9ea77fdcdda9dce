"""The dry run's ``zero3`` mode on the reference's ``16x16`` mesh
(256 fake ranks), on the CPU: every pair of ``dryrun_matrix()``
lowered at one unit of its published widths on meta fake tensors, its
arguments and its collectives by op held to counts made from the sharding
specs alone (``tests/_dryrun_modes.py``), ``long_500k``'s combine over the
16 ranks of the ``data`` axis.  No kernel is launched or loaded.
"""
import pytest
from _dryrun_modes import MATRIX, check_pair


@pytest.mark.parametrize("arch,shape", MATRIX)
def test_every_pair_lowers_zero3_on_16_16(arch, shape, monkeypatch):
    check_pair(arch, shape, "16x16", "zero3", monkeypatch)
