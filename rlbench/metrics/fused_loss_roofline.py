"""The fused lm-head loss kernels' share (%) of their roofline over the
traced steps: the least time of every forward (one per Preprocessor call
and per train step) and backward (one per train step) launch
(`flops.fused_loss_fwd` / `fused_loss_bwd`, N the rows times the padded
length, D the hidden size, V the vocabulary) over the device time of the
kernels of `repro::flp` and `repro::flp_tc`."""
from rlbench import flops
from rlbench.metrics._common import device_seconds

KERNEL = ("repro::flp",)


def read(rec):
    tr = rec.get("traced")
    secs = device_seconds(tr, KERNEL)
    if not secs:
        return None
    c, t = rec["cfg"], rec["traffic"]
    D, V = c["hidden_size"], c["vocab_size"]
    lo, hi = rec["t_open"], rec["t_prof_end"]
    bound = 0.0
    for label, a, b, info in rec["spans"]:
        if not (lo <= a and b <= hi):
            continue
        if label == "pre":
            f = flops.fused_loss_fwd(info["tokens"], D, V)
            bound += flops.bound_seconds(f["bytes"], f["flops"])
        elif label == "trainer":
            n = t["pack"]["rows"] * t["pack"]["seq"]
            for f in (flops.fused_loss_fwd(n, D, V),
                      flops.fused_loss_bwd(n, D, V)):
                bound += flops.bound_seconds(f["bytes"], f["flops"])
    return 100.0 * bound / secs
