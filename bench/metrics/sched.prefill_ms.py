"""Ms of the scheduler's ``sched.prefill`` spans (an admission group's prefill,
ending with the fetch of its first tokens) per request admitted."""
from bench.lib import readers


def read(rec):
    s = readers.spans(rec, "sched.prefill")
    n = sum(e[5].get("group", 0) for e in s)
    return 1e3 * sum(e[3] for e in s) / n if n else None
