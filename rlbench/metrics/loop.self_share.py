"""Share (%) of the window spent outside the calls into the engine, the
weight swap, the Preprocessor and the trainer: the loop's own host work."""
from rlbench.metrics._common import window_spans


def read(rec):
    spans = [s for label in ("decode", "refill", "swap", "pre", "trainer")
             for s in window_spans(rec, label)]
    w = rec["t_close"] - rec["t_open"]
    if not spans or w <= 0:
        return None
    return 100.0 * (w - sum(s[2] - s[1] for s in spans)) / w
