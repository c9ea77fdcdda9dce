"""Counterpart of :mod:`repro.core`: the paper's DAG model — ``policies``,
``dag`` (with the heterogeneous and failure axes), the event-driven
``simulator`` and ``predictor`` — and the what-if sweep whole: the batched
engine (``xputil``, ``hardware``, ``bucketsim``, ``analytical``, ``het``,
``costmodel``, ``archcost``, ``workloads``, ``scenarios``, ``resulttable``,
``batched``), its twin on the card (``batched_torch``), the sweep drivers
with the per-scenario and simulator paths and streaming (``sweep``), the
worker pool (``parallel``) and the persistent sweep service (``service``).

Copies of the reference's NumPy-only modules, with the reference's
arithmetic in the reference's order, so their results equal the
originals' bit for bit; ``tests/test_torch_predictor.py``,
``tests/test_torch_sweep_copies.py`` and ``tests/test_torch_sweep_paths.py``
pin them.
"""
