"""The MoE kernels of a training step against their bound: B1 (forward, dx,
dW), B2 and B3 in the traced steps, least time over device time, in %."""
from bench.lib import readers


def read(rec):
    return readers.roofline(rec, ("grouped_matmul", "grouped_matmul_dx",
                                  "grouped_matmul_dw", "dispatch", "combine"))
