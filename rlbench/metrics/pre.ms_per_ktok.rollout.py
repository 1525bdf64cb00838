"""Preprocessor (reference logprobs) host-clock ms, synced, per thousand
tokens it scored, on an actor's card."""
from rlbench.metrics._common import ms_per_ktok, window_spans


def read(rec):
    spans = window_spans(rec, "pre")
    return ms_per_ktok(rec, "pre", sum(s[3]["tokens"] for s in spans))
