"""Counterpart of :mod:`repro.launch`: the training and serving launchers
and the step builders they share."""
