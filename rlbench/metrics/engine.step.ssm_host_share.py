"""Share (%) of the traced window's decode steps' host time (each
`engine.step` span less its `engine.step.wait`) spent inside the
`model.decode.ssm` spans within them (under their `engine.step.enqueue`):
the enqueue of the Mamba2 layers' decode. None where no step holds such a
span (a configuration without Mamba2 layers, or a program without the
span)."""
from rlbench.program import in_window


def read(rec):
    p = rec.get("program")
    steps = set(in_window(p, "engine.step")) if p else set()
    if not steps:
        return None
    spans = p["spans"]
    host = sum(spans[i][2] - spans[i][1] for i in steps)
    ssm = 0.0
    for name, a, b, parent, _ in spans:
        if name == "engine.step.wait" and parent in steps:
            host -= b - a
        elif name == "model.decode.ssm" and parent >= 0 \
                and spans[parent][3] in steps:
            ssm += b - a
    if not ssm or host <= 0:
        return None
    return 100.0 * ssm / host
