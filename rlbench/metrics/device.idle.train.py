"""Share (%) of the traced window (whole optimizer-step cycles) in which no
kernel ran on the card."""
from rlbench.metrics._common import idle


def read(rec):
    return idle(rec)
