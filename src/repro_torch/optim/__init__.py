"""Counterpart of :mod:`repro.optim`."""
