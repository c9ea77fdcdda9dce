"""Counterpart of :mod:`repro.core`: the paper's DAG model, as far as the
port's model-vs-measured loop needs it (``policies``, ``dag``,
``simulator``, ``predictor.predict_sync_policy``), and since the sweep
slice the batched sweep engine (``xputil``, ``hardware``, ``bucketsim``,
``analytical``, ``het``, ``costmodel``, ``archcost``, ``workloads``,
``scenarios``, ``resulttable``, ``batched``, ``sweep``) with its twin on
the card, ``batched_torch``.

Copies of the reference's NumPy-only modules, with the reference's
arithmetic in the reference's order, so their results equal the
originals' bit for bit; ``tests/test_torch_predictor.py`` and
``tests/test_torch_sweep_copies.py`` pin them.
"""
