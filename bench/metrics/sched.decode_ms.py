"""Ms of a ``sched.decode`` span: one decode tick over the pool, ending with
the fetch of its tokens."""
from bench.lib import readers


def read(rec):
    s = readers.spans(rec, "sched.decode")
    return 1e3 * sum(e[3] for e in s) / len(s) if s else None
