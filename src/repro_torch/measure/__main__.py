"""``python -m repro_torch.measure`` — delegate to :mod:`repro_torch.measure.run`.

The guard matters: the spawned ranks import this module as ``__mp_main__``.
"""
import sys

from repro_torch.measure.run import main

if __name__ == "__main__":
    sys.exit(main())
