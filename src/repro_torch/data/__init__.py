"""Counterpart of :mod:`repro.data`."""
