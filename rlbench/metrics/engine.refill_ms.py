"""Mean host-clock time (ms, synced) of the refills in the window that
admitted a row: admission, chunked prefill, forks."""
from rlbench.metrics._common import window_spans


def read(rec):
    spans = [s for s in window_spans(rec, "refill") if s[3].get("admitted")]
    if not spans:
        return None
    return 1e3 * sum(s[2] - s[1] for s in spans) / len(spans)
