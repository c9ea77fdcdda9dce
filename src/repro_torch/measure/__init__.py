"""Instrumented execution of the port's train step: ``python -m repro_torch.measure``."""
