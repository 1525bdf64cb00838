"""Share (%) of the traced window in which the card is idle while the
innermost program span is `engine.step.enqueue`: the idle time of the
host enqueueing the decode step, which a CUDA graph can reclaim."""
from rlbench.program import idle_share


def read(rec):
    return idle_share(rec, ("engine.step.enqueue",))
