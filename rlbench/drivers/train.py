"""Driver of the trainer's share of a deployment (`driver: train`): per
optimizer step the Preprocessor and then `Trainer.step` on one packed
batch of finished rollouts, as the PipelineRL trainer stage runs them,
with no engine.

Set-up builds one Trainer and Preprocessor from the configuration file
and the mix, with weights drawn from the seed, and drives them through
the first `warm_steps` steps on rollouts from the seed (the steps the
reference follows). The window opens at the end of the last of them and
closes at the end of the first step that ends `seconds` or more after it.
"""
from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from rlbench import harness, port, traffic, weights
from rlbench.harness import Spans, sync


def run(ctx: Dict) -> Dict:
    from repro_torch import (AdamConfig, PreprocessConfig, Preprocessor,
                             RLConfig, Trainer, pack)
    from repro_torch.core.events import apply_group_baseline
    from repro_torch.data.packing import Rollout
    from repro_torch.kernels import ops

    c, t, seed = ctx["config"], ctx["traffic"], ctx["seed"]
    clock = ctx["clock"]
    trace, dev = ctx["trace"], torch.device(ctx["device"])
    cfg = port.config(c, ctx["device"])
    parts = {"import": clock.now()}
    if dev.type == "cuda":
        port.load_kernels(t["kernels"])
    parts["kernels"] = clock.now()
    spec = t["rollouts"]
    params = weights.make_params(c, seed, dev)
    parts["weights"] = clock.now()
    trainer = Trainer(cfg, params, rl=RLConfig(**t["rl"]),
                      adam=AdamConfig(**t["adam"]), device=dev)
    pre = Preprocessor(cfg, params, PreprocessConfig(
        kl_coef=t["preprocess"]["kl_coef"], max_len=spec["length"]),
        device=dev)
    p0 = [x for _, x in weights.leaves(params, c)]
    del params
    groups = traffic.rollout_groups(spec, seed, cfg.vocab_size)
    parts["system"] = clock.now()
    spans = Spans(clock)
    if trace:
        spans.wrap(pre, "_ref_logprobs", "pre",
                   lambda out, a, k: {"tokens": int(a[0].numel())})
        spans.wrap(trainer, "step", "trainer")

    steps: List[Dict] = []
    kept: List[List[Dict]] = []

    def one_step(keep: bool) -> None:
        """One optimizer step on the next two GRPO groups."""
        rows, rollouts = [], []
        for gi in range(spec["groups_per_step"]):
            g = next(groups)
            for r in g["rows"]:
                P = r["prompt_len"]
                wv = np.zeros(len(r["tokens"]), np.int32)
                wv[P:] = max(trainer.version - r["lag"], 0)
                rollouts.append(Rollout(
                    tokens=r["tokens"], prompt_len=P,
                    behavior_logprobs=r["beh"].copy(), reward=r["reward"],
                    weight_versions=wv, prompt_key=len(steps) * 16 + gi))
                rows.append(r)
        pre.process(rollouts)
        batch = pack(apply_group_baseline(rollouts), t["pack"]["rows"],
                     t["pack"]["seq"], trainer_version=trainer.version)
        stats = batch.pop("packing_stats")
        m = trainer.step(batch)
        bad = trainer.last_nonfinite()       # the step's host sync
        steps.append({"metrics": m, "bad": bad, "at": clock.now(),
                      "tokens": int((batch["segment_ids"] > 0).sum()),
                      "pre_tokens": sum(r.length for r in rollouts),
                      "dropped": stats["dropped"]})
        if keep:
            kept.append(rows)

    # ---- set-up: the first steps, which the reference follows ---------
    n_ref = t["check"]["ref_steps"]
    prog: Dict = {}
    for i in range(t["warm_steps"]):
        one_step(keep=i < n_ref)
        if i == 0:
            # the first gradient as Adam holds it: (1 - b1) g after a step
            prog["m1"] = {n: float(m.norm()) for n, m in
                          weights.leaves(trainer.state.opt.m, c)}
        if i == n_ref - 1:
            prog["change"] = {
                n: float((x.float() - y.float()).norm()) for (n, x), y in
                zip(weights.leaves(trainer.params, c), p0)}
    prog["loss"] = [float(s["metrics"]["loss"]) for s in steps[:n_ref]]
    gc.collect()
    sync()
    setup_s = clock.now()
    parts["warm"] = setup_s
    ops.reset_launches()

    # ---- the window ------------------------------------------------------
    t_open = setup_s
    k0 = len(steps)
    prof = prof_sum = t_prof_end = None
    if trace and dev.type == "cuda":
        prof = harness.Profile()
    while True:
        one_step(keep=False)
        sync()
        now = clock.now()
        if prof is not None and prof_sum is None \
                and len(steps) - k0 == t["traced_steps"]:
            t_prof_end = now
            # reading the trace is the benchmark's own work: out of the
            # window's clock
            with clock.pause():
                prof_sum = prof.summary(clock, t_open, now, spans)
        if now - t_open >= ctx["seconds"]:
            break
    t_close = now
    win = steps[k0:]
    window = {"seconds": t_close - t_open,
              "trained_tokens": sum(s["tokens"] for s in win),
              "pre_tokens": sum(s["pre_tokens"] for s in win),
              "opt_steps": len(win),
              "bad_steps": sum(bool(s["bad"]) for s in win),
              "dropped": sum(s["dropped"] for s in win),
              "step_ends_s": [round(s["at"] - t_open, 3) for s in win],
              "launches": dict(ops.launches)}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del trainer, pre, p0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    from rlbench.reference import check
    rows = [[{"tokens": r["tokens"], "prompt_len": r["prompt_len"],
              "beh": r["beh"].astype(np.float64), "reward": r["reward"]}
             for r in step] for step in kept]
    checks = check.train_numbers(c, t, seed, dev, rows,
                                 None if ctx.get("control") else prog,
                                 control=bool(ctx.get("control")))
    checks["steps_checked"] = len(kept)
    return {"setup_s": setup_s, "setup_parts": harness.setup_parts(parts),
            "window": window, "peak_bytes": peak,
            "attempted": window["opt_steps"], "failed": window["bad_steps"],
            "checks": checks, "spans": spans.spans, "decode": [],
            "traced": prof_sum, "t_open": t_open, "t_close": t_close,
            "t_prof_end": t_prof_end,
            "cfg": c, "traffic": t}
