"""Counterpart of :mod:`repro.models`."""
