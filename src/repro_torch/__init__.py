"""PyTorch/CUDA port of :mod:`repro`'s S-SGD measurement loop.

The package mirrors ``repro``'s module names (``repro_torch.models.attention``
is the counterpart of ``repro.models.attention``, and so on) and imports
``torch``, never ``jax`` and nothing of ``repro``.  Where it needs a pure
function of a NumPy-only ``repro`` module it keeps its own copy, pinned to
the original by a CPU test.

Slice 1 covers the path ``python -m repro_torch.measure --arch qwen1.5-4b``
walks: the dense decoder, the flash-attention kernels (forward and backward,
hand-written CUDA for Hopper in ``csrc/``), SGD, the three gradient-sync
schedules on ``torch.distributed`` and the trace writer.
"""
