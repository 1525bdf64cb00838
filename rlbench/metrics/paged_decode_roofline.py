"""`flash_decode_paged`'s share (%) of its roofline over the traced
cycles: the least time of every launch (`flops.paged_decode_launch`, one
per layer per decode step, lengths and block tables from the engine's host
mirrors at each step) over the device time of the kernel's launches."""
from rlbench import flops
from rlbench.metrics._common import device_seconds

KERNEL = ("PagedAddr",)


def read(rec):
    tr = rec.get("traced")
    secs = device_seconds(tr, KERNEL)
    if not secs or not rec.get("decode"):
        return None
    c, ec = rec["cfg"], rec["traffic"]["engine"]
    lo, hi = rec["t_open"], rec["t_prof_end"]
    bound = 0.0
    for t0, t1, lens, table in rec["decode"]:
        if not (lo <= t0 and t1 <= hi) or table is None:
            continue
        one = flops.paged_decode_launch(
            ec["n_slots"], c["num_attention_heads"], c["num_key_value_heads"],
            c["head_dim"], table.shape[1],
            flops.paged_valid_keys(table, lens, ec["page_size"]),
            int(sum(lens)))
        bound += c["num_hidden_layers"] * flops.bound_seconds(one["bytes"],
                                                              one["flops"])
    return 100.0 * bound / secs
