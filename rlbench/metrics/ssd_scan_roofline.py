"""`ssd_scan`'s share (%) of its roofline over the traced Preprocessor
calls: the least time of every launch, one per Mamba2 layer per call
(`launch`), over the device time of the kernel's launches (`repro::ssd`).
A call's rows are the mix's `batch_size` and its length the padded tokens
of the benchmark's `pre` span over them; the widths are the
configuration's. None where no launch ran (a configuration without Mamba2
layers)."""
from rlbench import flops
from rlbench.metrics._common import device_seconds

KERNEL = ("repro::ssd::",)
ELT = {"bfloat16": 2, "float32": 4}


def block(chunk: int) -> int:
    """The chunk the kernel walks: the largest divisor of the configuration's
    chunk up to 64 tokens."""
    return max(q for q in range(1, min(chunk, 64) + 1) if chunk % q == 0)


def launch(c, rows: int, length: int):
    """One launch over `rows` sequences of `length` tokens: x, B and C (the
    model's type), dt and A (float32) read once, y written once in the
    model's type and the final state in float32. Operations: per block of
    Q tokens the causal pairs' C B^T (2 N a pair and group) and their
    product with x (2 P a pair and head), and the state's two products,
    B^T x into it and C out of it (2 Q N P each a head)."""
    e = ELT[c["torch_dtype"]]
    H, P = c["mamba_n_heads"], c["mamba_d_head"]
    G, N = c["mamba_n_groups"], c["mamba_d_state"]
    Q = block(c["mamba_chunk_size"])
    tok = rows * length
    nbytes = (tok * (2 * H * P + 2 * G * N) * e + tok * H * 4 + H * 4
              + rows * H * P * N * 4)
    pairs = Q * (Q + 1) // 2
    per_block = G * 2 * pairs * N + H * (2 * pairs * P + 4 * Q * N * P)
    return {"bytes": float(nbytes), "flops": float(per_block * tok / Q)}


def read(rec):
    tr = rec.get("traced")
    secs = device_seconds(tr, KERNEL)
    if not secs:
        return None
    c, rows = rec["cfg"], rec["traffic"]["batch_size"]
    layers = c["layer_types"].count("mamba")
    lo, hi = rec["t_open"], rec["t_prof_end"]
    bound = 0.0
    for label, a, b, info in rec["spans"]:
        if label == "pre" and lo <= a and b <= hi:
            one = launch(c, rows, info["tokens"] // rows)
            bound += layers * flops.bound_seconds(one["bytes"], one["flops"])
    return 100.0 * bound / secs
