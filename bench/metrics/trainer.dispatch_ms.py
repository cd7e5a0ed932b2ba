"""Host ms a training step spends enqueuing its work: the program's
``chunk.execute`` spans of the window (each runs a same-decision run of steps
and ends when the last is enqueued, before the chunk's fetch), per step."""
from bench.lib import readers


def read(rec):
    s = readers.spans(rec, "chunk.execute")
    if not s or not rec.get("steps"):
        return None
    return 1e3 * sum(e[3] for e in s) / rec["steps"]
