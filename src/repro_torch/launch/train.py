"""End-to-end RL training driver.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --mode pipeline --steps 60 --batch 16 --lr 3e-3 \
        --ckpt-dir ckpt/pipelinerl [--device cpu]

Runs PipelineRL (or the Conventional RL baseline) on the synthetic math
reasoning task with the tiny testbed model (the CPU-scale twin of the
paper's Qwen-2.5-7B runs), logging reward/ESS/lag per optimizer step and
writing periodic checkpoints. The JAX package's CLI, flag for flag, plus
`--device` (the card unless `--device cpu`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from repro_torch.checkpoint import checkpoint
from repro_torch.configs.tiny import config as tiny_config
from repro_torch.core.algo import RLConfig
from repro_torch.core.conventional import ConventionalConfig, ConventionalRL
from repro_torch.core.evaluator import Evaluator
from repro_torch.core.pipeline import PipelineConfig, PipelineRL
from repro_torch.core.preprocess import PreprocessConfig, Preprocessor
from repro_torch.core.rollout import EngineConfig
from repro_torch.core.trainer import Trainer
from repro_torch.data.math_task import MathTask
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim.adam import AdamConfig
from repro_torch.optim.schedule import warmup_constant


def initial_params(cfg, seed: int, device):
    """The run's initial weights: random, from `seed`, on `device`."""
    return M.init_params(cfg, seed, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("pipeline", "conventional"),
                    default="pipeline")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--g", type=int, default=4, help="G for conventional")
    ap.add_argument("--slots", type=int, default=16, help="H generation batch")
    ap.add_argument("--max-len", type=int, default=16)
    ap.add_argument("--chips", type=int, default=8)
    ap.add_argument("--train-chips", type=int, default=4)
    ap.add_argument("--engines", type=int, default=1,
                    help="actor-pool size: independent generation engines "
                         "sharing the N-T generation chips (DESIGN.md §7)")
    ap.add_argument("--engine-speeds", default=None,
                    help="comma-separated per-engine HardwareModel speed "
                         "overrides (heterogeneous pool), e.g. '2.0,1.0' "
                         "— len must equal --engines")
    ap.add_argument("--router",
                    choices=("fifo", "shortest_queue", "length_affinity"),
                    default="fifo",
                    help="PoolRouter admission policy between the shared "
                         "prompt source and the pool (DESIGN.md §7 pool "
                         "scheduling)")
    ap.add_argument("--broadcast", choices=("streamed", "atomic", "free"),
                    default="streamed",
                    help="weight-publication mode: streamed chunks overlap "
                         "decode (brief per-chunk pause), atomic stalls "
                         "decode for the whole transfer, free is the "
                         "legacy zero-cost swap")
    ap.add_argument("--bcast-chunks", type=int, default=8,
                    help="layer chunks per streamed publication")
    ap.add_argument("--lag-mode", choices=("off", "token_is", "truncated"),
                    default="off",
                    help="staleness-corrected objective (DESIGN.md §12): "
                         "token_is = per-token lag-conditional IS clamp, "
                         "truncated = Truncated-PPO staleness horizon; off "
                         "is bit-identical to the uncorrected loss")
    ap.add_argument("--max-lag", type=int, default=None,
                    help="periodic asynchrony (pipeline mode): bound every "
                         "trained token's weight lag — actors pause at the "
                         "bound, pack() masks over-bound tokens. 0 = "
                         "conventional-RL lockstep, unset = free-running")
    ap.add_argument("--ckpt-pause", type=float, default=0.0,
                    help="simulated trainer stall (flashes) every "
                         "--ckpt-every steps (queue back-pressure study)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--d-model", type=int, default=96)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--max-operand", type=int, default=3)
    ap.add_argument("--fused-loss", action="store_true",
                    help="fused lm-head cross-entropy trainer path "
                         "(DESIGN.md §6: no logits materialization)")
    ap.add_argument("--recompute-kv", action="store_true",
                    help="§5.1 ablation: recompute cache at weight updates")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-plan", default=None,
                    help="chaos testing (DESIGN.md §8/§10): comma-separated "
                         "fault specs, e.g. 'engine:0@300r200' (crash engine "
                         "0 at t=300, restart 200 flashes later), "
                         "'trainer@500r100', 'pre@400', "
                         "'link:1@600d300p0.5' (lossy broadcast link); gray "
                         "faults: 'slow:0@300d200x4' (4x cost window), "
                         "'hang:1@300[r60]' (engine wedges; watchdog "
                         "detects, optional restart 60 flashes after "
                         "detection), 'corrupt@300d200p0.5' (damaged weight "
                         "chunks, checksum-gated), 'nan@500x3' (3 non-finite "
                         "trainer steps), 'poison@7' (7th prompt wedges its "
                         "engine); or 'chaos:<seed>[:<horizon>]' for a "
                         "seeded random plan; pipeline mode only")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="greedy held-out eval every N optimizer steps")
    ap.add_argument("--kl-coef", type=float, default=0.0,
                    help="reference-KL reward shaping (preprocessor stage)")
    ap.add_argument("--warmup", type=int, default=0,
                    help="LR warmup steps (0 = constant)")
    ap.add_argument("--log-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the engines and the trainer run (cuda or "
                         "cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.mode == "conventional" and args.max_lag is not None:
        ap.error("--max-lag is a pipeline-mode knob (conventional RL is "
                 "already the max_lag=0 lag structure by construction)")

    task = MathTask(max_operand=args.max_operand, ops="+")
    cfg = tiny_config(vocab_size=task.tok.vocab_size, d_model=args.d_model,
                      n_layers=args.layers)
    if args.fused_loss:
        cfg = dataclasses.replace(cfg, fused_loss=True)
    params = initial_params(cfg, args.seed, device)
    schedule = warmup_constant(args.lr, args.warmup) if args.warmup else None
    trainer = Trainer(cfg, params,
                      rl=RLConfig(entropy_coef=0.003,
                                  lag_mode=args.lag_mode),
                      adam=AdamConfig(lr=args.lr), lr_schedule=schedule,
                      device=device)
    ec = EngineConfig(n_slots=args.slots, max_len=args.max_len)
    pack_rows = max(2, args.batch * args.max_len // 320)
    preprocessor = None
    if args.kl_coef > 0:
        # freeze the init policy as pi_ref (paper Fig. 4 middle stage)
        preprocessor = Preprocessor(
            cfg, params, PreprocessConfig(kl_coef=args.kl_coef,
                                          max_len=args.max_len),
            device=device)
    evaluator = Evaluator(cfg, task, max_len=args.max_len, device=device) \
        if args.eval_every else None

    engine_speeds = None
    if args.engine_speeds:
        engine_speeds = [float(x) for x in args.engine_speeds.split(",")]

    fault_plan = None
    if args.fault_plan:
        from repro_torch.core.events import FaultPlan
        fault_plan = FaultPlan.parse(args.fault_plan,
                                     n_engines=args.engines)

    if args.mode == "pipeline":
        runner = PipelineRL(
            cfg, params, task, ec,
            PipelineConfig(batch_size=args.batch, n_opt_steps=args.steps,
                           n_chips=args.chips, train_chips=args.train_chips,
                           pack_rows=pack_rows, pack_seq=80,
                           recompute_kv=args.recompute_kv,
                           n_engines=args.engines, broadcast=args.broadcast,
                           broadcast_chunks=args.bcast_chunks,
                           engine_speeds=engine_speeds, router=args.router,
                           ckpt_every=(args.ckpt_every if args.ckpt_pause
                                       or args.ckpt_dir else 0),
                           ckpt_pause=args.ckpt_pause,
                           ckpt_dir=args.ckpt_dir,
                           max_lag=args.max_lag),
            trainer=trainer, seed=args.seed, preprocessor=preprocessor,
            fault_plan=fault_plan, device=device)
    else:
        runner = ConventionalRL(
            cfg, params, task, ec,
            ConventionalConfig(batch_size=args.batch, g_steps=args.g,
                               n_opt_steps=args.steps, n_chips=args.chips,
                               pack_rows=pack_rows, pack_seq=80),
            trainer=trainer, seed=args.seed, device=device)

    ckpt_paths = []
    last_v = 0
    while trainer.version < args.steps:
        target = min(trainer.version + args.ckpt_every, args.steps)
        runner.run(target)
        for r in runner.log[last_v:]:
            print(f"step {r['version']:4d}  t={r['time']:9.0f}f  "
                  f"reward={r['reward']:+.3f}  ess={r.get('ess', 0):.3f}  "
                  f"max_lag={r['max_lag']:.0f}  loss={r.get('loss', 0):+.4f}",
                  flush=True)
        last_v = len(runner.log)
        if args.ckpt_dir:
            path = os.path.join(args.ckpt_dir, f"step{trainer.version}.npz")
            checkpoint.save(path, trainer.state.params)
            ckpt_paths.append(path)
            print(f"checkpoint -> {path}", flush=True)
        if evaluator and args.eval_every and \
                trainer.version % args.eval_every == 0:
            ev = evaluator.evaluate(trainer.state.params)
            print(f"eval @ step {trainer.version}: "
                  f"success_rate={ev['success_rate']:.3f} "
                  f"mean_len={ev['mean_len']:.1f}", flush=True)

    if args.mode == "pipeline":
        bs = runner.broadcast_stats()
        eng = bs["engines"]
        print(f"broadcast[{bs['mode']}]: {bs['published']} publications, "
              f"mean decode pause/update = "
              f"{np.mean([e['pause_per_update'] for e in eng]):.2f}f "
              f"across {len(eng)} engine(s)", flush=True)
        if args.max_lag is not None or args.lag_mode != "off":
            ls = runner.lag_stats()
            bound = "inf" if ls["bound"] is None else str(ls["bound"])
            print(f"lag[bound={bound},mode={args.lag_mode}]: "
                  f"max={ls['max_lag']} mean={ls['mean_lag']:.2f} over "
                  f"{ls['trained_tokens']} trained tokens, "
                  f"masked={ls['masked_tokens']}, hist={ls['histogram']}",
                  flush=True)
        if args.router != "fifo" or engine_speeds:
            rs = runner.router_stats()
            print(f"router[{rs['policy']}]: " + ", ".join(
                f"{e['name']}(x{e['speed']:g})={e['assigned']}p/"
                f"{e['prompt_tokens']}tok/{e['declined']}decl"
                for e in rs["engines"]), flush=True)
        if fault_plan is not None:
            ps = runner.pool_stats()
            tr = ps["trainer"]
            print(f"faults: {len(runner.fault_log)} events, "
                  f"rollouts_lost={ps['rollouts_lost']}, "
                  f"prompts_salvaged={ps['prompts_salvaged']}, "
                  f"requeued={ps['prompts_requeued']}, "
                  f"quarantined={ps['prompts_quarantined']}, "
                  f"trainer crashes={tr['crashes']} "
                  f"(steps_lost={tr['steps_lost']}, "
                  f"restored from v{tr['last_ckpt_version']})", flush=True)
            if runner.monitor is not None:
                h = ps["health"]
                print(f"health: {h['sweeps']} sweeps, "
                      f"hangs_detected={h['hangs_detected']}, "
                      f"stragglers_demoted={h['stragglers_demoted']}/"
                      f"restored={h['stragglers_restored']}", flush=True)
            bc = ps["broadcast"]
            if bc["chunks_corrupt"] or bc["wchunks_rejected"]:
                print(f"integrity: chunks_corrupt={bc['chunks_corrupt']}, "
                      f"rejected={bc['wchunks_rejected']}, "
                      f"torn={bc['wstreams_torn']}", flush=True)

    if args.log_out:
        os.makedirs(os.path.dirname(args.log_out) or ".", exist_ok=True)
        with open(args.log_out, "w") as f:
            json.dump(runner.log, f, indent=1)
        print(f"log -> {args.log_out}")


if __name__ == "__main__":
    main()
