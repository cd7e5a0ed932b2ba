"""Model FLOPs of the window's scheduler ticks (what the requests' prompts
and generated tokens grew by in them, lib/flops.py) over the seconds those
ticks took, at the bf16 peak, in %: the chip's share of its peak while the
scheduler has work (an open loop below its knee leaves it idle between
arrivals, which says nothing of the step)."""
from bench.lib import readers


def read(rec):
    return readers.mfu(rec, "busy_s")
