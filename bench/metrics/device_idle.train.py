"""Share of the traced training steps with no operation on the device, in %."""
from bench.lib import readers


def read(rec):
    return readers.idle(rec)
