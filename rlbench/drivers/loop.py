"""Driver of the PipelineRL loop on one card (`driver: loop`).

Set-up builds one `PipelineRL` (its paged engine, Preprocessor and
Trainer) from the configuration file and the mix, with weights drawn from
the seed, and runs it to the end of its `warm_steps`-th optimizer step,
which builds and warms every kernel and shape the loop uses. The window
opens there and closes at the end of the first optimizer step that ends
`seconds` or more after it; its length is the denominator of every rate.

The check follows the program from its own state, version by version: the
benchmark copies the trainer's weights of each version to the host (with
the window's clock paused) while the rollouts it will check are in flight,
and the reference replays those rollouts under them (`reference/replay.py`).
The rollouts checked are two whole GRPO groups admitted after the window
opens (which two: from the seed); the loop runs on past the close, out of
the window, until they are trained.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Dict, List

import numpy as np
import torch

from rlbench import harness, port, traffic, weights
from rlbench.harness import Spans, sync


class Snapshots:
    """The trainer's weights by version, copied to the host."""

    def __init__(self):
        self.by_version: Dict[int, List[torch.Tensor]] = {}

    def take(self, c: Dict, version: int, tree) -> None:
        if version in self.by_version or version == 0:
            return
        self.by_version[version] = [x.detach().to("cpu", copy=True)
                                    for _, x in weights.leaves(tree, c)]

    def prune(self, keep_from: int) -> None:
        for v in [v for v in self.by_version if v < keep_from]:
            del self.by_version[v]


def run(ctx: Dict) -> Dict:
    from repro_torch import (AdamConfig, EngineConfig, HardwareModel,
                             PipelineConfig, PipelineRL, PreprocessConfig,
                             Preprocessor, RLConfig, Trainer)
    from repro_torch.core.weights import tree_bytes
    from repro_torch.data.math_task import MathTask, Problem
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
    pc = PipelineConfig(n_opt_steps=t["warm_steps"], **t["pipeline"])
    trainer = Trainer(cfg, params, rl=RLConfig(**t["rl"]),
                      adam=AdamConfig(**t["adam"]), device=dev)
    pre = Preprocessor(cfg, params, PreprocessConfig(
        kl_coef=t["preprocess"]["kl_coef"], max_len=ec.max_len), device=dev)
    base = HardwareModel()
    per_chip = ec.n_slots / (pc.n_chips - pc.train_chips)
    hw = dataclasses.replace(base, bcast_bytes_per_flash=tree_bytes(params) / (
        t["hardware"]["bcast_decode_steps"] * base.step_cost(per_chip)))
    prompts = traffic.grpo_prompts(t["prompts"], seed, cfg.vocab_size)

    def source():
        g, ids = next(prompts)
        prob = Problem(ids, 0)
        prob.rlbench_group = g
        return prob

    p = PipelineRL(cfg, params, MathTask(), ec, pc, hw=hw, trainer=trainer,
                   preprocessor=pre, prompt_source=source,
                   seed=seed % (2 ** 62), device=dev)
    eng, actor = p.engine, p.actors[0]
    parts["system"] = clock.now()
    del params

    st = {"open": None, "keep": 1 << 30, "groups": set(), "admitted": 0,
          "processed": [],
          "steps": [], "delivered": [], "decode": []}
    slot_info: Dict[int, tuple] = {}
    sample_groups: set = set()     # chosen when the window opens
    snaps = Snapshots()
    recent: Dict[int, Dict] = {}
    spans = Spans(clock)

    if trace:
        spans.wrap(eng, "refill", "refill", lambda n, a, k: {"admitted": n})
        spans.wrap_decode(eng, st["decode"], ctx.get("recording"))
        spans.wrap(eng, "stream_weight_chunk", "swap",
                   lambda done, a, k: {"version": eng._wstream["version"]
                                       if eng._wstream else eng.version,
                                       "done": bool(done)})
        spans.wrap(pre, "_ref_logprobs", "pre",
                   lambda out, a, k: {"tokens": int(a[0].numel())})
        spans.wrap(trainer, "step", "trainer")

    def sample_floor() -> int:
        """The oldest version the check may still need."""
        vs = [v for (g, v) in slot_info.values() if g in sample_groups]
        vs += [d["admit"] for d in st["delivered"] if d["group"]
               in sample_groups]
        return min(vs + [eng.version])

    def sample_done() -> bool:
        return bool(sample_groups) and sum(
            d["group"] in sample_groups for d in st["delivered"]) \
            >= len(sample_groups) * t["prompts"]["group"]

    raw_refill = eng.refill

    def refill(*a, **k):
        before = eng._host_active.copy()
        n = raw_refill(*a, **k)
        for s in np.nonzero(eng._host_active & ~before)[0]:
            g = eng.problems[s].rlbench_group
            st["groups"].add(g)
            st["admitted"] += st["open"] is not None
            slot_info[int(s)] = (g, eng.version)
        return n

    raw_deliver = actor.deliver

    def deliver(rollouts, at):
        for r in rollouts:
            g, v = slot_info.get(r.slot, (None, 0))
            st["delivered"].append({"r": r, "group": g, "admit": v,
                                    "at": clock.now()})
        raw_deliver(rollouts, at)

    raw_process = pre.process

    def process(rollouts):
        st["processed"].append(list(rollouts))
        return raw_process(rollouts)

    raw_train = trainer.step

    def train_step(batch, *a, **k):
        m = raw_train(batch, *a, **k)
        st["steps"].append({"tokens": int((batch["segment_ids"] > 0).sum()),
                            "at": clock.now()})
        # the trainer's newest trees, by reference (the trainer and its
        # stage hold the last two anyway), for the weight-swap check
        recent[trainer.version] = trainer.params
        for old in sorted(recent)[:-2]:
            del recent[old]
        # the check's copies: every version while a checked rollout may
        # still need it
        if not sample_done():
            # copying and freeing host memory: out of the window's clock
            with clock.pause():
                snaps.take(c, trainer.version, trainer.params)
                snaps.prune(min(sample_floor(), st["keep"]))
        return m

    eng.refill, actor.deliver, pre.process = refill, deliver, process
    trainer.step = train_step

    # ---- set-up: warm through the first optimizer steps ---------------
    v = t["warm_steps"]
    p.run(v)
    gc.collect()
    sync()
    setup_s = clock.now()
    parts["warm"] = setup_s
    ops.reset_launches()

    # ---- the window ------------------------------------------------------
    t_open = setup_s
    st["open"] = t_open
    st["keep"] = v
    # the checked groups: two whose first copy comes after the window
    # opens, which two from the seed
    first = max(st["groups"], default=-1) + 1 + seed % 3
    sample_groups.update(range(first, first + t["check"]["sample_groups"]))
    c0 = {"tokens": eng.tokens_generated, "prefill": eng.prefill_tokens,
          "steps": len(st["steps"]), "delivered": len(st["delivered"]),
          "pre_calls": len(st["processed"]), "lost": actor.rollouts_lost,
          "v": v}
    prof = None
    if trace and dev.type == "cuda":
        prof = harness.Profile()
    t_prof_end = None
    while True:
        v += 1
        p.run(v)
        sync()
        now = clock.now()
        if prof is not None and t_prof_end is None \
                and v == c0["v"] + t["traced_steps"]:
            t_prof_end = now
            # reading the trace is the benchmark's own work: out of the
            # window's clock
            with clock.pause():
                prof_sum = prof.summary(clock, t_open, now, spans)
        if now - t_open >= ctx["seconds"]:
            break
    t_close = now
    window = {
        "seconds": t_close - t_open,
        "sampled_tokens": eng.tokens_generated - c0["tokens"],
        "prefill_tokens": eng.prefill_tokens - c0["prefill"],
        "trained_tokens": sum(s["tokens"] for s in st["steps"][c0["steps"]:]),
        "opt_steps": v - c0["v"],
        "pre_tokens": sum(r.length for b in st["processed"][c0["pre_calls"]:]
                          for r in b),
        "delivered": len(st["delivered"]) - c0["delivered"],
        "admitted": st["admitted"],
        "lost": actor.rollouts_lost - c0["lost"],
        "queue_at_close": len(p.queue),
        "check_pause_s": clock.paused,
        "step_ends_s": [round(x["at"] - t_open, 3)
                        for x in st["steps"][c0["steps"]:]],
        "launches": dict(ops.launches),
    }
    bad_lp = sum(1 for d in st["delivered"][c0["delivered"]:]
                 if not np.isfinite(d["r"].behavior_logprobs).all())
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    # ---- out of the window: the checked rollouts to their end ----------
    extra = 0
    while not (sample_done() and all(
            d["r"].ref_logprobs is not None for d in st["delivered"]
            if d["group"] in sample_groups)):
        if extra >= t["check"]["max_extra_steps"]:
            break
        v += 1
        extra += 1
        p.run(v)
    sync()
    swap = _swap_check(c, eng, recent, snaps)
    sample = [_plain(d["r"], d["admit"]) for d in st["delivered"]
              if d["group"] in sample_groups]
    # the window's first optimizer step: its rollouts, loss, version
    step_batch = [_plain(r, 0) for r in st["processed"][c0["steps"]]]
    entry = p.log[c0["v"]]
    if int(entry["version"]) != c0["v"] + 1:
        raise SystemExit(f"log entry {c0['v']} is version {entry['version']}")
    step_loss = float(entry["loss"])
    pre_version = c0["v"]
    versions = dict(snaps.by_version)
    # free the program's state before the reference runs
    del p, eng, actor, trainer, pre, recent, raw_refill, raw_train
    del raw_deliver, raw_process
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks = _check(c, t, seed, dev, sample, versions, step_batch,
                    step_loss, pre_version, ctx.get("control", False))
    checks["swap_leaves_differ"] = swap
    checks["unmoved_leaf_share"] = _unmoved(versions)
    checks["rollouts_unchecked"] = (len(sample_groups)
                                    * t["prompts"]["group"] - len(sample))
    rec = {"setup_s": setup_s, "setup_parts": harness.setup_parts(parts),
           "window": window, "peak_bytes": peak,
           "attempted": window["admitted"],
           "failed": window["lost"] + bad_lp, "checks": checks,
           "spans": spans.spans, "decode": st["decode"],
           "traced": prof_sum if prof is not None else None,
           "t_open": t_open, "t_close": t_close, "t_prof_end": t_prof_end,
           "cfg": c, "traffic": t}
    return rec


def _plain(r, admit: int) -> Dict:
    """A rollout as plain arrays, for the reference."""
    return {"tokens": np.asarray(r.tokens), "prompt_len": int(r.prompt_len),
            "stamps": np.asarray(r.weight_versions),
            "beh": np.asarray(r.behavior_logprobs, np.float64),
            "ref": (None if r.ref_logprobs is None
                    else np.asarray(r.ref_logprobs, np.float64)),
            "reward": float(r.reward), "admit_version": int(admit)}


def _swap_check(c: Dict, eng, recent: Dict, snaps: Snapshots):
    """Leaves of the engine's weights that differ from the trainer's
    weights of the version the engine says it holds (None: neither a
    reference nor a copy of that version was kept)."""
    v = int(eng.version)
    got = [x for _, x in weights.leaves(eng.params, c)]
    if v in recent:
        want = [x for _, x in weights.leaves(recent[v], c)]
        return sum(not torch.equal(a, b) for a, b in zip(got, want))
    if v in snaps.by_version:
        return sum(not torch.equal(a.detach().cpu(), b)
                   for a, b in zip(got, snaps.by_version[v]))
    return None


def _unmoved(versions: Dict[int, List[torch.Tensor]]) -> float:
    """The largest share, over pairs of consecutive versions kept, of the
    leaves that one optimizer step left bit for bit unchanged."""
    out = 0.0
    ks = sorted(versions)
    for a, b in zip(ks, ks[1:]):
        if b != a + 1:
            continue
        same = sum(torch.equal(x, y) for x, y in zip(versions[a],
                                                     versions[b]))
        out = max(out, same / len(versions[a]))
    return out


def _check(c, t, seed, dev, sample, versions, step_batch, step_loss,
           pre_version, control) -> Dict:
    """The numbers compared with the plain reference (`reference/`)."""
    from rlbench.reference import check
    return check.loop_numbers(c, t, seed, dev, sample, versions,
                              step_batch, step_loss, pre_version, control)
