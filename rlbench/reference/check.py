"""The numbers that decide `correct`: what the timed path produced, held
against the plain float32 reference. Imports nothing of the program; the
drivers hand it plain arrays and the weights they kept.

`control=True` puts the reference itself in float8 in the program's
place: every weight matrix rounded to e4m3 with one scale per output
column (of a layer's slice of a stacked leaf), and every input of a weight
product and every query, key and value with one scale per row (the
operands of float8 matrix products and a float8 attention, with a float8
cache). The readings it gives are the control's, which a limit must fail.

The reference reads the seed's weights in the type they are served in and
takes each to float32 where it is used (the architecture's
`Model.weight`): the same numbers as a float32 copy of the tree, without
the copy's memory.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from rlbench import arch, weights
from rlbench.reference import rl
from rlbench.reference.model import exact_float32
from rlbench.reference.replay import replay


def fp8_cols(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one absmax scale for each index of its
    last axis (an output column), back in float32. The reference applies it
    to each weight as read (`Model.weight`: a layer's slice of a stacked
    leaf), so a scale covers one layer's column; a vector (a norm's scale)
    is kept, as a float8 product keeps it outside the product."""
    if x.dim() < 2:
        return x
    dims = tuple(range(x.dim() - 1))
    amax = x.abs().amax(dim=dims, keepdim=True).clamp(min=1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one absmax scale per row (last axis),
    back in float32: an activation as a float8 product reads it."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def fp8_model(c: Dict, tree: Dict):
    return arch.model(c, tree, act=fp8_rows, quant=fp8_cols)


def _f32(c: Dict, tensors: List[torch.Tensor], dev) -> Dict:
    return weights.tree_of(c, [x.to(dev, torch.float32) for x in tensors])


def full_logprobs(model, tokens: np.ndarray, dev) -> np.ndarray:
    """Each position's logprob of its token under the prefix before it."""
    t = torch.as_tensor(np.asarray(tokens), device=dev, dtype=torch.long)[None]
    with torch.no_grad():
        hn, _ = model.hidden(t)
        lp = rl.shifted_logprobs(model, hn, t, 1)
    return lp[0].double().cpu().numpy()


def _rollout_loss(model, ref_model, rows: List[Dict],
                  t: Dict, dev) -> float:
    """The loss of one optimizer step on `rows` (reference rewards from
    the frozen initial weights), without gradients."""
    batch = _batch(ref_model, rows, t, dev)
    with torch.no_grad():
        return float(rl.loss_of(model, batch, t["rl"]))


def _batch(ref_model, rows: List[Dict], t: Dict, dev) -> Dict:
    """A step's rows as (n, T) tensors with the reference's KL-shaped
    rewards. Rows of unequal length are right-padded and masked."""
    T = max(len(r["tokens"]) for r in rows)
    n = len(rows)
    tok = np.zeros((n, T), np.int64)
    mask = np.zeros((n, T))
    beh = np.zeros((n, T))
    for i, r in enumerate(rows):
        L, P = len(r["tokens"]), r["prompt_len"]
        tok[i, :L] = r["tokens"]
        mask[i, P:L] = 1.0
        beh[i, :L] = r["beh"][:L]
    tok_t = torch.as_tensor(tok, device=dev)
    with torch.no_grad():
        hn, _ = ref_model.hidden(tok_t)
        ref = rl.shifted_logprobs(ref_model, hn, tok_t, 1)
    del hn
    f = lambda a: torch.as_tensor(a, device=dev, dtype=torch.float32)
    reward = f(np.array([r["reward"] for r in rows]))
    rewards = rl.token_rewards(reward, f(beh), ref, f(mask),
                               t["preprocess"]["kl_coef"])
    return {"tokens": tok_t, "mask": f(mask), "beh": f(beh),
            "rewards": rewards}


def _gaps(name: str, diffs: List[np.ndarray]) -> Dict[str, float]:
    """The widest gap and the RMS gap over every compared token."""
    if not diffs:
        return {name + "_gap": np.inf, name + "_rms": np.inf}
    d = np.concatenate(diffs)
    return {name + "_gap": float(np.abs(d).max()),
            name + "_rms": float(np.sqrt(np.mean(d * d)))}


def rollout_numbers(c: Dict, seed: int, dev, sample: List[Dict],
                    control: bool = False) -> Dict:
    """engine_lp_gap / _rms: the widest and the RMS gap between a checked
    rollout's behavior logprobs of its sampled tokens and the reference's
    forward under the seed's weights, which the engine held throughout;
    pre_lp_gap / _rms: the same for the Preprocessor's reference
    logprobs. With `control`, the float8 reference's forward stands in
    for both."""
    exact_float32()
    p0 = weights.make_params(c, seed, dev)
    m0 = arch.model(c, p0)
    m0_q = fp8_model(c, p0) if control else None
    eng, pre = [], []
    for r in sample:
        P = r["prompt_len"]
        want = full_logprobs(m0, r["tokens"], dev)[P:]
        if control:
            got = full_logprobs(m0_q, r["tokens"], dev)[P:]
            eng.append(got - want)
            pre.append(got - want)
            continue
        eng.append(r["beh"][P:] - want)
        pre.append(np.full(1, np.inf) if r["ref"] is None
                   else r["ref"][P:] - want)
    out: Dict[str, float] = {
        "checked_rollouts": len(sample),
        "checked_tokens": sum(len(r["tokens"]) - r["prompt_len"]
                              for r in sample)}
    out.update(_gaps("engine_lp", eng))
    out.update(_gaps("pre_lp", pre))
    return out


def loop_numbers(c: Dict, t: Dict, seed: int, dev, sample: List[Dict],
                 versions: Dict[int, List[torch.Tensor]],
                 step_rows: List[Dict], step_loss: float, pre_version: int,
                 control: bool = False) -> Dict:
    """engine_lp_gap: the widest gap between a checked rollout's behavior
    logprob and the reference's replay of it; pre_lp_gap: the widest gap
    between the Preprocessor's reference logprobs and the reference's
    forward under the initial weights; loss_gap: the gap between the
    window's first optimizer-step loss and the reference's loss of the
    same rollouts under the weights that step started from."""
    exact_float32()
    p0 = weights.make_params(c, seed, dev)
    missing = sorted({int(v) for r in sample for v in
                      np.concatenate([[r["admit_version"]],
                                      r["stamps"][r["prompt_len"]:]])
                      if v and int(v) not in versions})
    out: Dict[str, float] = {"checked_rollouts": len(sample),
                             "checked_tokens": sum(len(r["tokens"])
                                                   - r["prompt_len"]
                                                   for r in sample),
                             "missing_versions": len(missing)}

    def weights_of(v: int) -> Dict:
        return p0 if v == 0 else _f32(c, versions[v], dev)

    m0 = arch.model(c, p0)
    m0_q = fp8_model(c, p0) if control else None
    diffs = []
    for r in sample:
        P = r["prompt_len"]
        want = full_logprobs(m0, r["tokens"], dev)[P:]
        got = (full_logprobs(m0_q, r["tokens"], dev)[P:] if control
               else r["ref"][P:] if r["ref"] is not None else None)
        diffs.append(np.full(1, np.inf) if got is None else got - want)
    out.update(_gaps("pre_lp", diffs))
    del m0_q
    if missing or not sample:
        out.update(engine_lp_gap=np.inf, engine_lp_rms=np.inf)
    else:
        ref = replay(c, lambda v: arch.model(c, weights_of(v)), sample,
                     dev)
        if control:
            got = replay(c, lambda v: fp8_model(c, weights_of(v)), sample,
                         dev)
        else:
            got = [r["beh"][r["prompt_len"]:] for r in sample]
        out.update(_gaps("engine_lp", [a - b for a, b in zip(got, ref)]))
    if pre_version in versions or pre_version == 0:
        w = weights_of(pre_version)
        ref_loss = _rollout_loss(arch.model(c, w), m0, step_rows, t,
                                 dev)
        if control:
            step_loss = _rollout_loss(fp8_model(c, w), m0, step_rows, t,
                                      dev)
        out["loss_gap"] = abs(step_loss - ref_loss)
        out["loss_ref"] = ref_loss
    else:
        out["loss_gap"] = np.inf
    return out


def _ref_train(c: Dict, t: Dict, seed: int, dev, steps: List[List[Dict]],
               quant=None) -> Dict:
    """The reference's first steps from the seed's weights: each step's
    loss, the first Adam moment's and the first gradient's norm by leaf,
    and the weights' change by leaf."""
    p0 = weights.make_params(c, seed, dev)
    batches = [_batch(arch.model(c, p0), rows, t, dev) for rows in steps]
    # Adam's float32 weights, which the steps update in place: a copy
    # even of a leaf that is float32 already
    p32 = weights.tree_of(c, [x.to(torch.float32, copy=True)
                              for _, x in weights.leaves(p0, c)])
    got = rl.train_steps(c, p32, batches, t["rl"], t["adam"], rows=1,
                         quant=quant, act=fp8_rows if quant else None)
    del batches
    got["change"] = {n: float((x - y.float()).norm()) for (n, x), (_, y)
                     in zip(weights.leaves(p32, c), weights.leaves(p0, c))}
    return got


def train_numbers(c: Dict, t: Dict, seed: int, dev, steps: List[List[Dict]],
                  prog: Optional[Dict], control: bool = False) -> Dict:
    """loss1_gap: the gap between the program's first loss and the
    reference's, over the larger of 1 and the reference's loss (the gaps
    of every step are reported as `loss_gaps`); grad_leaf_gap: the widest
    gap, by leaf, between the norm of the program's first gradient (its
    first Adam moment over 1 - b1) and the reference's, over the larger of
    the reference leaf's norm and the median leaf's; change_leaf_gap: the
    same for the weights' change over the steps, over the leaves whose
    first reference gradient is above a thousandth of the median leaf's;
    change_median_gap: the median leaf's gap of the change;
    unmoved_leaf_share: the share of the leaves that the reference moves
    and the program leaves unchanged. With `control`, the reference in
    float8 stands in for the program."""
    exact_float32()
    ref = _ref_train(c, t, seed, dev, steps)
    if control:
        prog = _ref_train(c, t, seed, dev, steps, quant=fp8_cols)
    names = list(ref["m1"])

    def leaf_gaps(p: Dict, r: Dict, keep) -> Dict[str, float]:
        med = float(np.median([r[n] for n in keep]))
        return {n: abs(p[n] - r[n]) / max(r[n], med, 1e-30) for n in keep}

    g_med = float(np.median([ref["g1"][n] for n in names]))
    moved = [n for n in names if ref["g1"][n] > 1e-3 * g_med]
    grad = leaf_gaps(prog["m1"], ref["m1"], names)
    chg = leaf_gaps(prog["change"], ref["change"], moved)
    n = len(prog["loss"])
    gaps = [abs(a - b) / max(abs(b), 1.0) for a, b in
            zip(prog["loss"], ref["loss"][:n])]
    # a leaf the reference moves and the program leaves bit for bit as it
    # was: no sound run (a step under half an ulp of the stored type)
    unmoved = [k for k in names if prog["change"][k] == 0.0
               and ref["change"][k] > 0.0]
    return {"loss1_gap": gaps[0], "loss_gaps": gaps,
            "unmoved_leaf_share": len(unmoved) / len(names),
            "unmoved_leaves": unmoved,
            "loss_ref": ref["loss"][:n], "loss_prog": prog["loss"],
            "grad_leaf_gap": max(grad.values()),
            "grad_worst_leaf": max(grad, key=grad.get),
            "change_leaf_gap": max(chg.values()),
            "change_worst_leaf": max(chg, key=chg.get),
            "change_median_gap": float(np.median(list(chg.values()))),
            "leaves_left_out": sorted(set(names) - set(moved))}
