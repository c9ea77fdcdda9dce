"""Counterpart of :mod:`repro.kernels`."""
