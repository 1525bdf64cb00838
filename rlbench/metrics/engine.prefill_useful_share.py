"""Share (%) of chunked prefill's row-tokens that prefill a prompt, over
the traced window: the engine's prompt tokens prefilled (`prefill_tokens`,
P-1 per prefilled row) over rows x chunk of every chunk call
(`prefill_row_tokens`). A chunk runs the rows the refill admitted (a
leader with its forks, which prefill nothing); every slot runs only for
MoE configs, mesh engines and a refill that fills every slot."""
from rlbench.program import counter_delta


def read(rec):
    p = rec.get("program")
    got = counter_delta(p) if p else None
    if not got or not got[0]["prefill_row_tokens"]:
        return None
    d = got[0]
    return 100.0 * d["prefill_tokens"] / d["prefill_row_tokens"]
