"""End to end: tokens the engine sampled in the window over its length."""


def read(rec):
    w = rec["window"]
    return w["sampled_tokens"] / w["seconds"] if w["seconds"] else None
