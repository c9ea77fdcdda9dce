"""Counterpart of :mod:`repro.traces`."""
