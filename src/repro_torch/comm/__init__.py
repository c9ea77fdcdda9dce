"""Counterpart of :mod:`repro.comm`."""
