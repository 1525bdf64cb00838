"""Driver of PipelineRL's generation side on one card (`driver: rollout`):
the actor and preprocessor stages with no trainer, as an actor's card of a
deployment runs them. One paged `GenerationEngine` decodes GRPO groups;
every `batch_size` finished rollouts go through the `Preprocessor` (the
reference model's logprobs and the KL-shaped rewards), as
`PreprocessStage` batches them for the trainer.

Set-up builds the engine and the Preprocessor from the configuration file
and the mix, with weights drawn from the seed, and runs until
`warm_batches` batches have been preprocessed, which builds and warms
every kernel and shape the cell uses. The window opens there and closes
at the end of the first batch preprocessed `seconds` or more after it;
its length is the denominator of the rate.

The check: two whole GRPO groups admitted after the window opens (which
two: from the seed) run to their end, out of the window where need be,
and the plain reference scores them under the seed's weights, which the
engine and the Preprocessor hold throughout: the engine's behavior
logprobs of the sampled tokens and the Preprocessor's reference logprobs.
"""
from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from rlbench import harness, port, traffic, weights
from rlbench.harness import Spans, sync


def run(ctx: Dict) -> Dict:
    from repro_torch import (EngineConfig, GenerationEngine,
                             PreprocessConfig, Preprocessor)
    from repro_torch.data.math_task import Problem
    from repro_torch.kernels import ops

    c, t, seed = ctx["config"], ctx["traffic"], ctx["seed"]
    clock = ctx["clock"]
    trace, dev = ctx["trace"], torch.device(ctx["device"])
    cfg = port.config(c, ctx["device"])
    parts = {"import": clock.now()}
    if dev.type == "cuda":
        port.load_kernels(t["kernels"])
    parts["kernels"] = clock.now()
    params = weights.make_params(c, seed, dev)
    parts["weights"] = clock.now()
    ec = EngineConfig(**t["engine"])
    pre = Preprocessor(cfg, params, PreprocessConfig(
        kl_coef=t["preprocess"]["kl_coef"], max_len=ec.max_len), device=dev)
    prompts = traffic.grpo_prompts(t["prompts"], seed, cfg.vocab_size)

    def source():
        g, ids = next(prompts)
        prob = Problem(ids, 0)
        prob.rlbench_group = g
        return prob

    eng = GenerationEngine(cfg, params, ec, source, seed=seed % (2 ** 62),
                           device=dev)
    del params
    parts["system"] = clock.now()

    spans = Spans(clock)
    decode: List = []
    if trace:
        spans.wrap(eng, "refill", "refill", lambda n, a, k: {"admitted": n})
        spans.wrap_decode(eng, decode, ctx.get("recording"))
        spans.wrap(pre, "_ref_logprobs", "pre",
                   lambda out, a, k: {"tokens": int(a[0].numel())})

    B = t["batch_size"]
    st = {"open": False, "admitted": 0}
    slot_group: Dict[int, int] = {}
    groups: set = set()
    finished: List[tuple] = []     # (rollout, group), in finishing order
    pending: List = []             # finished, not yet preprocessed
    batches: List[Dict] = []

    def tick() -> bool:
        """One decode step with the refill before it, and the Preprocessor
        on a batch once `B` rollouts wait; True when a batch was done."""
        before = eng._host_active.copy()
        eng.refill()
        for s in np.nonzero(eng._host_active & ~before)[0]:
            g = eng.problems[s].rlbench_group
            groups.add(g)
            st["admitted"] += st["open"]
            slot_group[int(s)] = g
        for r in eng.step():
            finished.append((r, slot_group.get(r.slot)))
            pending.append(r)
        if len(pending) < B:
            return False
        batch = pending[:B]
        del pending[:B]
        pre.process(batch)
        batches.append({"tokens": sum(r.length for r in batch),
                        "at": clock.now()})
        return True

    # ---- set-up: warm through the first batches -----------------------
    while len(batches) < t["warm_batches"]:
        tick()
    gc.collect()
    sync()
    setup_s = clock.now()
    parts["warm"] = setup_s
    ops.reset_launches()

    # ---- the window ------------------------------------------------------
    t_open = setup_s
    st["open"] = True
    # the checked groups: two whose first copy comes after the window
    # opens, which two from the seed
    first = max(groups) + 1 + seed % 3
    sample = set(range(first, first + t["check"]["sample_groups"]))
    c0 = {"tokens": eng.tokens_generated, "prefill": eng.prefill_tokens,
          "batches": len(batches), "finished": len(finished)}
    prof = prof_sum = t_prof_end = None
    if trace and dev.type == "cuda":
        prof = harness.Profile()
    while True:
        if not tick():
            continue
        sync()
        now = clock.now()
        if prof is not None and prof_sum is None \
                and len(batches) - c0["batches"] == t["traced_batches"]:
            t_prof_end = now
            # reading the trace is the benchmark's own work: out of the
            # window's clock
            with clock.pause():
                prof_sum = prof.summary(clock, t_open, now, spans)
        if now - t_open >= ctx["seconds"]:
            break
    t_close = now
    done = finished[c0["finished"]:]
    window = {
        "seconds": t_close - t_open,
        "sampled_tokens": eng.tokens_generated - c0["tokens"],
        "prefill_tokens": eng.prefill_tokens - c0["prefill"],
        "pre_tokens": sum(b["tokens"] for b in batches[c0["batches"]:]),
        "batches": len(batches) - c0["batches"],
        "finished": len(done),
        "admitted": st["admitted"],
        "batch_ends_s": [round(b["at"] - t_open, 3)
                         for b in batches[c0["batches"]:]],
        "launches": dict(ops.launches),
    }
    bad_lp = sum(1 for r, _ in done
                 if not np.isfinite(r.behavior_logprobs).all())
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    # ---- out of the window: the checked groups to their end ------------
    want = len(sample) * t["prompts"]["group"]
    for _ in range(t["check"]["max_extra_steps"]):
        got = [r for r, g in finished if g in sample]
        if len(got) >= want and all(r.ref_logprobs is not None
                                    for r in got):
            break
        tick()
    sync()
    checked = [_plain(r) for r, g in finished if g in sample]
    del eng, pre, finished, pending
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    from rlbench.reference import check
    checks = check.rollout_numbers(c, seed, dev, checked,
                                   bool(ctx.get("control")))
    checks["rollouts_unchecked"] = want - len(checked)
    return {"setup_s": setup_s, "setup_parts": harness.setup_parts(parts),
            "window": window, "peak_bytes": peak,
            "attempted": window["admitted"], "failed": bad_lp,
            "checks": checks, "spans": spans.spans, "decode": decode,
            "traced": prof_sum, "t_open": t_open, "t_close": t_close,
            "t_prof_end": t_prof_end, "cfg": c, "traffic": t}


def _plain(r) -> Dict:
    """A finished rollout as plain arrays, for the reference."""
    return {"tokens": np.asarray(r.tokens), "prompt_len": int(r.prompt_len),
            "stamps": np.asarray(r.weight_versions),
            "beh": np.asarray(r.behavior_logprobs, np.float64),
            "ref": (None if r.ref_logprobs is None
                    else np.asarray(r.ref_logprobs, np.float64))}
