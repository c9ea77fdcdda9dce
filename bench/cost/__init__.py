"""The yardstick's frozen arithmetic: the card's peaks, the least time of
each flash and wkv6 kernel at a shape, and a training step's FLOPs.  Copied
from the program's ``kernels/cost.py`` and ``core/archcost.py`` and pinned
by the benchmark's own tests, so a later change to the program cannot move
it."""
