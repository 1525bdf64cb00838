"""Host<->device transfers that make the host wait for the card, in decode
steps, refills and the page code, per decode step of the traced window
(the engine's `blocking_transfers`)."""
from rlbench.program import counter_delta


def read(rec):
    p = rec.get("program")
    got = counter_delta(p) if p else None
    if not got:
        return None
    d, steps = got
    return d["blocking_transfers"] / steps
