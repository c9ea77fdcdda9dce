"""Bundled traces from the paper.

``ALEXNET_K80`` is Table VI of the paper **verbatim**: one iteration of
AlexNet on two K80 GPUs (times in microseconds, sizes in bytes).  The
paper's full downloadable trace archive is not reachable offline; this
table is the published sample from it.  A copy of
:mod:`repro.traces.bundled`, resolved by the ``trace:`` workload provider
(``trace:alexnet-k80``).
"""
from __future__ import annotations

from repro_torch.traces.format import Trace, make_trace

# Table VI — AlexNet, one iteration, K80 GPU (id, name, fwd, bwd, comm, size)
_ALEXNET_K80_ROWS = [
    (0, "data", 1.20e6, 0, 0, 0),
    (1, "conv1", 3.27e6, 288202, 123.424, 139776),
    (2, "relu1", 17234.5, 27650.9, 0, 0),
    (3, "pool1", 32175.7, 60732.6, 0, 0),
    (4, "conv2", 3.14e6, 1.03216e6, 292.032, 1229824),
    (5, "relu2", 11507.5, 18422.5, 0, 0),
    (6, "pool2", 19831.2, 32459, 0, 0),
    (7, "conv3", 3.886e6, 791825, 288214, 3540480),
    (8, "relu3", 4770.3, 10996.3, 0, 0),
    (9, "conv4", 1.87e6, 510405, 1.03218e6, 2655744),
    (10, "relu4", 4760.26, 7872.45, 0, 0),
    (11, "conv5", 1.13e6, 306129, 275772, 1770496),
    (12, "relu5", 3201.22, 4939.42, 0, 0),
    (13, "pool5", 5812, 18666.2, 0, 0),
    (14, "fc6", 44689.7, 73935, 311170, 151011328),
    (15, "relu6", 295.168, 1092.83, 0, 0),
    (16, "drop6", 359.744, 131247, 0, 0),
    (17, "fc7", 19787.8, 34423.8, 610376, 67125248),
    (18, "relu7", 295.04, 451.904, 0, 0),
    (19, "drop7", 358.048, 317.312, 0, 0),
    (20, "fc8", 8033.12, 9922.72, 130964, 16388000),
    (21, "loss", 1723.49, 293.024, 0, 0),
]

# Table IV's AlexNet config: 1024 samples per GPU per iteration.
ALEXNET_K80: Trace = make_trace("alexnet", "k80-pcie-10gbe", _ALEXNET_K80_ROWS,
                                batch_per_gpu=1024)

#: Bundled traces the ``trace:`` workload provider resolves by name.
BUNDLED_TRACES: dict[str, Trace] = {"alexnet-k80": ALEXNET_K80}

TOTAL_GRAD_BYTES = sum(r[5] for r in _ALEXNET_K80_ROWS)   # ~244 MB = 61M f32
