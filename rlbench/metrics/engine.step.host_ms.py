"""Mean host time (ms) of the traced window's decode steps: the program's
`engine.step` span less its `engine.step.wait` (the read of the step's
finished mask), i.e. page preparation, enqueue and bookkeeping."""
from rlbench.program import children, in_window


def read(rec):
    p = rec.get("program")
    steps = in_window(p, "engine.step") if p else []
    if not steps:
        return None
    total = 0.0
    for i in steps:
        s = p["spans"][i]
        w = children(p, i).get("engine.step.wait")
        total += (s[2] - s[1]) - ((w[2] - w[1]) if w else 0.0)
    return 1e3 * total / len(steps)
