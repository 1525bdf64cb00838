"""Model FLOPs of the window over its length and the card's bf16 peak (%):
6 N per trained token, 2 N per sampled, prefilled and Preprocessor token,
N the active parameters less the input embedding. Attention's context
FLOPs and the recompute of activation checkpointing are not counted."""
from rlbench.metrics._common import mfu


def read(rec):
    w = rec["window"]
    return mfu(rec, w["trained_tokens"],
               w["sampled_tokens"] + w["prefill_tokens"] + w["pre_tokens"])
