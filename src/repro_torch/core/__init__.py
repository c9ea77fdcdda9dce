"""Counterpart of :mod:`repro.core`: the paper's DAG model, as far as the
port's model-vs-measured loop needs it (``policies``, ``dag``,
``simulator``, ``predictor.predict_sync_policy``).

Plain Python copies of the reference's NumPy-free modules, with the
reference's arithmetic in the reference's order, so their results equal
the originals' bit for bit; ``tests/test_torch_predictor.py`` pins them.
"""
