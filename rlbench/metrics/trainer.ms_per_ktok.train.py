"""Trainer.step host-clock ms, synced, per thousand trained (non-pad)
tokens, in the trainer cells."""
from rlbench.metrics._common import ms_per_ktok


def read(rec):
    return ms_per_ktok(rec, "trainer", rec["window"]["trained_tokens"])
