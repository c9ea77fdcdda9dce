"""The port's benchmark: S-SGD training cells run by ``bench/run.py``."""
