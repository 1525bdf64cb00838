"""The decode step's share (%) of its roofline over the traced window: for
each traced decode step (the benchmark's own record of it, with its
active rows' key lengths and block table), the step's least time
(`step`: every weight read once, the valid keys and values of the
attention layers read and the new ones written, the conv and SSD state of
every active row read and written by each Mamba2 layer), summed, over the
card's busy time inside those steps (the program's device activity on the
window clock). None without the program's map of the device's activity."""
from rlbench import flops, weights

ELT = {"bfloat16": 2, "float32": 4}


def step(c, lens, table, page_size: int):
    """One decode step's bytes and operations over the active rows of key
    lengths `lens` (the new token's key included) and block table
    `table`."""
    e = ELT[c["torch_dtype"]]
    rows, keys = len(lens), int(sum(lens))
    d = c["hidden_size"]
    params = 0
    nbytes = rows * d * e                          # the embedding's rows
    for path, shape, dt, _ in weights.leaf_specs(c):
        if path == ("embed",):
            continue
        n = 1
        for s in shape:
            n *= s
        params += n
        nbytes += n * ELT[dt]
    types = c.get("layer_types") or ["attention"] * c["num_hidden_layers"]
    n_attn = types.count("attention")
    n_ssm = len(types) - n_attn
    KV, Dh, H = c["num_key_value_heads"], c["head_dim"], \
        c["num_attention_heads"]
    valid = flops.paged_valid_keys(table, lens, page_size)
    nbytes += n_attn * 2 * (valid + rows) * KV * Dh * e
    ops = 2.0 * params * rows + n_attn * 4.0 * keys * H * Dh
    if n_ssm:
        Hs, P = c["mamba_n_heads"], c["mamba_d_head"]
        N, G = c["mamba_d_state"], c["mamba_n_groups"]
        ch = c["mamba_expand"] * d + 2 * G * N
        state = (c["mamba_d_conv"] - 1) * ch * e + Hs * P * N * 4
        nbytes += n_ssm * 2 * rows * state
        ops += n_ssm * rows * 4.0 * Hs * P * N
    return {"bytes": float(nbytes), "flops": ops}


def busy_within(busy, a: float, b: float) -> float:
    return sum(max(0.0, min(y, b) - max(x, a)) for x, y in busy)


def read(rec):
    p = rec.get("program")
    if not p or p.get("busy") is None or not rec.get("decode") \
            or rec.get("t_prof_end") is None:
        return None
    c, ec = rec["cfg"], rec["traffic"]["engine"]
    lo, hi = rec["t_open"], rec["t_prof_end"]
    least = busy = 0.0
    for t0, t1, lens, table in rec["decode"]:
        if not (lo <= t0 and t1 <= hi) or table is None:
            continue
        one = step(c, lens, table, ec["page_size"])
        least += flops.bound_seconds(one["bytes"], one["flops"])
        busy += busy_within(p["busy"], t0, t1)
    return 100.0 * least / busy if busy else None
