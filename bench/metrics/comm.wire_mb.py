"""MB a step puts on the wire from one chip: the program's
``comm.COUNTER`` wire bytes over the window (every all-to-all, forward and
backward, at (n - 1)/n of its bytes), per step."""


def read(rec):
    if not rec.get("wire_bytes") or not rec.get("steps"):
        return None
    return rec["wire_bytes"] / rec["steps"] / 1e6
