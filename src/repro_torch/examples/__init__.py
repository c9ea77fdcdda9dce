"""The port's twins of the reference's examples and of its Table VI
bench, each run as ``python -m repro_torch.examples.<name>`` (on CUDA
unless ``--device cpu`` is given)."""
