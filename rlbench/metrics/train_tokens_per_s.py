"""End to end: non-pad tokens that passed the Preprocessor and an optimizer
step in the window, over its length."""


def read(rec):
    w = rec["window"]
    return w["trained_tokens"] / w["seconds"] if w["seconds"] else None
