"""Model FLOPs of the window's training steps (lib/flops.py) over the window
at the bf16 peak of one H100 (989 TFLOP/s), in %."""
from bench.lib import readers


def read(rec):
    return readers.mfu(rec)
