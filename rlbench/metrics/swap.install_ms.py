"""Host-clock time (ms, synced) of installing one published version into
the engine: its streamed chunks summed, over the versions whose last chunk
landed in the window."""
from rlbench.metrics._common import window_spans


def read(rec):
    spans = window_spans(rec, "swap")
    per = {}
    for s in spans:
        per.setdefault(s[3]["version"], []).append(s)
    done = [v for v, ss in per.items() if any(x[3]["done"] for x in ss)]
    if not done:
        return None
    return 1e3 * sum(x[2] - x[1] for v in done for x in per[v]) / len(done)
