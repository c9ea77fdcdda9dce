"""Counterpart of :mod:`repro.checkpoint`."""
