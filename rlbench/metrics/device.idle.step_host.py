"""Share (%) of the traced window in which the card is idle while the
innermost program span is `engine.step.pages` or `engine.step.finish`:
host work of the decode step around its device work, which overlap or
non-blocking copies can reclaim."""
from rlbench.program import idle_share


def read(rec):
    return idle_share(rec, ("engine.step.pages", "engine.step.finish"))
