"""B4 (the fused MoE kernel) in the traced ticks against its bound: least
time over device time, in %."""
from bench.lib import readers


def read(rec):
    return readers.roofline(rec, ("fused_moe",))
