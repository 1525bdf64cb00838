"""Mean host-clock time (ms) of the engine's decode steps in the window
(each ends in the step's own device-to-host read)."""
from rlbench.metrics._common import window_spans


def read(rec):
    spans = window_spans(rec, "decode")
    if not spans:
        return None
    return 1e3 * sum(s[2] - s[1] for s in spans) / len(spans)
