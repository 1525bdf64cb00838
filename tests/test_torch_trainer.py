"""The port's training path (`pack`, `reinforce_loss`, Adam and the
schedules, packed-batch attention, `Preprocessor`, `Trainer`, checkpoints)
against the JAX package's, on the CPU, at the tiny dense config (2 layers,
d 64, tied embeddings, float32), and the JAX package's own laws asserted
again inside the port.

Both sides start from the same weights (`M.init_params` -> numpy -> torch)
and get the same numpy inputs. Tolerances (float32): 1e-6 on the loss and
its metrics from identical per-token inputs; 1e-5 on model outputs (the
model tests' bound); after each of three Adam steps at lr 1e-3, metrics
within 1e-5, and params within 1e-6 but for at most 0.1% of the elements,
which stay within 5e-5 (`_close_params`: Adam moves an element by
lr * m / (sqrt(v) + 1e-8), and where the gradient itself is of the order
of 1e-8 its last digits, which differ between the packages, decide a
fraction of lr).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.tiny import config as jax_tiny
from repro.core import algo as jalgo
from repro.core.preprocess import PreprocessConfig as JPreprocessConfig
from repro.core.preprocess import Preprocessor as JPreprocessor
from repro.core.trainer import Trainer as JTrainer
from repro.data.packing import Rollout as JRollout
from repro.data.packing import pack as jpack
from repro.models import attention as jattn
from repro.models import model as JM
from repro.optim import adam as jadam
from repro.optim import schedule as jsched
from repro.sharding import tree_values
from repro_torch.configs import tiny as port_tiny
from repro_torch.convert import (params_from_numpy, train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.core import algo
from repro_torch.core.preprocess import PreprocessConfig, Preprocessor
from repro_torch.core.trainer import Trainer
from repro_torch.core.weights import tree_flatten
from repro_torch.data.packing import Rollout, pack
from repro_torch.models import attention as tattn
from repro_torch.optim import adam as tadam
from repro_torch.optim import schedule as tsched
from repro_torch.optim.adam import AdamConfig

VOCAB = 40
ADAM = dict(lr=1e-3)


def _configs(**kw):
    return (dataclasses.replace(jax_tiny(vocab_size=VOCAB, d_model=64), **kw),
            dataclasses.replace(port_tiny.config(vocab_size=VOCAB, d_model=64),
                                **kw))


@functools.lru_cache(maxsize=None)
def _numpy_params():
    jcfg, _ = _configs()
    return jax.tree.map(np.asarray, tree_values(
        JM.init_params(jcfg, jax.random.PRNGKey(0))))


def _pair_params(tcfg):
    tree = _numpy_params()
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, device="cpu"))


def _rollouts(n, seed=0, max_len=40, versions=False):
    """The same rollouts as each package's Rollout."""
    rng = np.random.default_rng(seed)
    fields = []
    for _ in range(n):
        L = int(rng.integers(8, max_len))
        pl = int(rng.integers(2, 6))
        lp = np.where(np.arange(L) >= pl, -rng.random(L) * 3, 0)
        wv = (np.where(np.arange(L) >= pl, rng.integers(0, 4, L), 0)
              if versions else np.zeros(L))
        fields.append(dict(
            tokens=rng.integers(0, VOCAB, L).astype(np.int32), prompt_len=pl,
            behavior_logprobs=lp.astype(np.float32),
            reward=float(rng.integers(0, 2)),
            weight_versions=np.sort(wv).astype(np.int32),
            truncated=bool(rng.integers(0, 2))))
    return ([JRollout(**{k: np.copy(v) if isinstance(v, np.ndarray) else v
                         for k, v in f.items()}) for f in fields],
            [Rollout(**{k: np.copy(v) if isinstance(v, np.ndarray) else v
                        for k, v in f.items()}) for f in fields])


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, jax_value, atol, msg=""):
    if isinstance(port, torch.Tensor):
        port = port.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(jax_value, np.float32), atol=atol,
                               rtol=0, err_msg=msg)


def _close_params(port_tree, jax_tree, msg=""):
    for a, b in zip(tree_flatten(port_tree)[0], jax.tree.leaves(jax_tree)):
        a = a.detach().float().numpy()
        b = np.asarray(b, np.float32)
        off = np.abs(a - b) > 1e-6
        assert off.mean() <= 1e-3, f"{msg}: {off.sum()} of {off.size} off"
        _close(a, b, 5e-5, msg)


# ---------------------------------------------------------------------------
# pack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lag", [None, dict(trainer_version=5),
                                 dict(trainer_version=5, max_lag=2)])
def test_pack_is_byte_equal_to_jax(lag):
    jr, tr = _rollouts(9, seed=1, versions=True)
    kw = lag or {}
    j = jpack(jr, batch=3, seq=64, **kw)
    t = pack(tr, batch=3, seq=64, **kw)
    assert set(j) == set(t)
    for k in j:
        if k == "packing_stats":
            assert j[k] == t[k]
        else:
            assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape, k
            assert j[k].tobytes() == t[k].tobytes(), k


# ---------------------------------------------------------------------------
# reinforce_loss, Adam, schedules
# ---------------------------------------------------------------------------

def _loss_inputs(seed=0, B=2, S=16, lag=True):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, S), np.float32)
    mask[:, :4] = 0
    batch = {
        "tokens": rng.integers(0, VOCAB, (B, S)).astype(np.int32),
        "loss_mask": mask,
        "behavior_logprobs": (-rng.random((B, S)) * 3).astype(np.float32),
        "rewards": rng.random((B, S)).astype(np.float32),
    }
    if lag:
        batch["lag"] = rng.integers(0, 6, (B, S)).astype(np.int32)
        batch["truncated"] = rng.integers(0, 2, (B, S)).astype(np.float32)
    stats = {"token_logprobs": (-rng.random((B, S)) * 3).astype(np.float32),
             "entropy": rng.random((B, S)).astype(np.float32)}
    values = rng.random((B, S)).astype(np.float32)
    return batch, stats, values


@pytest.mark.parametrize("rl", [
    dict(), dict(lag_mode="token_is"), dict(lag_mode="truncated"),
    dict(lag_mode="truncated", truncated_weight=0.5, entropy_coef=0.01)])
def test_reinforce_loss_matches_jax(rl):
    batch, stats, values = _loss_inputs()
    jl, jm = jalgo.reinforce_loss(
        jax.tree.map(jnp.asarray, stats), jnp.asarray(values),
        jax.tree.map(jnp.asarray, batch), jalgo.RLConfig(**rl))
    tl, tm = algo.reinforce_loss(
        {k: _t(v) for k, v in stats.items()}, _t(values),
        {k: _t(v) for k, v in batch.items()}, algo.RLConfig(**rl))
    _close(tl, jl, 1e-6, "loss")
    assert set(jm) == set(tm)
    for k in jm:
        _close(tm[k], jm[k], 1e-6, k)


def test_reinforce_loss_from_logits_matches_jax():
    """The unfused path: per-token stats taken from (B,S,V) logits."""
    batch, _, values = _loss_inputs(lag=False)
    logits = np.random.default_rng(3).standard_normal(
        (2, 16, VOCAB)).astype(np.float32)
    jl, jm = jalgo.reinforce_loss(jnp.asarray(logits), None,
                                  jax.tree.map(jnp.asarray, batch),
                                  jalgo.RLConfig())
    tl, tm = algo.reinforce_loss(_t(logits), None,
                                 {k: _t(v) for k, v in batch.items()},
                                 algo.RLConfig())
    _close(tl, jl, 1e-6)
    for k in jm:
        _close(tm[k], jm[k], 1e-6, k)


def test_adam_and_schedules_match_jax():
    """Three Adam updates (clipped, weight decay, a warmup-cosine lr) on a
    small tree; params, moments and norms agree."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 2)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                          shapes, is_leaf=lambda x: isinstance(x, tuple))
    cfg = dict(lr=1e-2, weight_decay=0.01, grad_clip=1.0)
    sched = (jsched.warmup_cosine(1e-2, 2, 6),
             tsched.warmup_cosine(1e-2, 2, 6))
    jp, tp = jax.tree.map(jnp.asarray, params), jax.tree.map(_t, params)
    js, ts = jadam.adam_init(jp), tadam.adam_init(tp)
    for step in range(3):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 2).astype(
            np.float32), params)
        jlr = sched[0](js.step)
        tlr = sched[1](ts.step)
        _close(tlr, jlr, 1e-9, "lr")
        jp, js, jn = jadam.adam_update(jp, jax.tree.map(jnp.asarray, g), js,
                                       jadam.AdamConfig(**cfg), lr=jlr)
        tp, ts, tn = tadam.adam_update(tp, jax.tree.map(_t, g), ts,
                                       tadam.AdamConfig(**cfg), lr=tlr)
        _close(tn, jn, 1e-5, "grad norm")
        for a, b in zip(tree_flatten(tp)[0], jax.tree.leaves(jp)):
            _close(a, b, 1e-6, f"params, step {step}")
        for a, b in zip(tree_flatten(ts.m)[0] + tree_flatten(ts.v)[0],
                        jax.tree.leaves(js.m) + jax.tree.leaves(js.v)):
            _close(a, b, 1e-6, f"moments, step {step}")
        assert int(ts.step) == int(js.step)


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)), ("warmup_cosine", (1e-3, 4, 20, 0.2)),
    ("warmup_constant", (1e-3, 5))])
def test_schedules_match_jax(name, args):
    jfn, tfn = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for s in range(0, 25, 3):
        _close(tfn(torch.tensor(s, dtype=torch.int32)),
               jfn(jnp.asarray(s, jnp.int32)), 1e-10, f"step {s}")


def test_adam_update_is_functional():
    """The inputs are never written: an engine may hold the params."""
    p = {"w": torch.ones(4, 3), "b": torch.zeros(3)}
    g = {"w": torch.full((4, 3), 0.5), "b": torch.ones(3)}
    st = tadam.adam_init(p)
    before = [x.clone() for x in tree_flatten((p, st.m, st.v))[0]]
    new_p, new_st, _ = tadam.adam_update(p, g, st, tadam.AdamConfig(lr=0.1))
    for a, b in zip(tree_flatten((p, st.m, st.v))[0], before):
        assert torch.equal(a, b)
    assert not torch.equal(new_p["w"], p["w"])


def test_large_leaves_update_in_slices_bitwise(monkeypatch):
    """A leaf above the slice size is updated slice by slice along its
    first axis, with the same bits as the whole-leaf update."""
    rng = np.random.default_rng(4)
    p = {"w": _t(rng.standard_normal((6, 5, 4)).astype(np.float32))}
    g = {"w": _t(rng.standard_normal((6, 5, 4)).astype(np.float32))}
    st = tadam.adam_init(p)
    whole = tadam.adam_update(p, g, st, tadam.AdamConfig(lr=0.1))
    monkeypatch.setattr(tadam, "_SLICE", 40)
    assert len(tadam._slices(p["w"])) == 3
    sliced = tadam.adam_update(p, g, st, tadam.AdamConfig(lr=0.1))
    for a, b in zip(tree_flatten(sliced)[0], tree_flatten(whole)[0]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# packed-batch attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,window", [(64, 0), (1024, 0), (1024, 100)])
def test_segment_masked_attention_matches_jax(S, window):
    """S=1024 takes the blocked online-softmax path (two 512-blocks), S=64
    the naive one, on both sides."""
    rng = np.random.default_rng(S + window)
    B, H, KV, D = 2, 4, 2, 8
    q, k, v = (rng.standard_normal((B, S, n, D)).astype(np.float32)
               for n in (H, KV, KV))
    cuts = np.sort(rng.integers(1, S, (B, 3)), axis=1)
    seg = np.stack([np.searchsorted(c, np.arange(S), side="right") + 1
                    for c in cuts]).astype(np.int32)
    seg[0, -5:] = 0                      # a pad tail, as pack leaves it
    j = jattn.blocked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=D ** -0.5,
        segment_ids=jnp.asarray(seg), window=window)
    t = tattn.blocked_causal_attention(
        _t(q), _t(k), _t(v), scale=D ** -0.5, segment_ids=_t(seg),
        window=window)
    _close(t, j, 1e-5)


# ---------------------------------------------------------------------------
# Preprocessor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_preprocessor_matches_jax(fused):
    jcfg, tcfg = _configs(fused_loss=fused)
    jp, tp = _pair_params(tcfg)
    jr, tr = _rollouts(5, seed=2, max_len=60)
    JPreprocessor(jcfg, jp, JPreprocessConfig(kl_coef=0.05,
                                              max_len=64)).process(jr)
    Preprocessor(tcfg, tp, PreprocessConfig(kl_coef=0.05, max_len=64),
                 device="cpu").process(tr)
    for a, b in zip(tr, jr):
        _close(a.ref_logprobs, b.ref_logprobs, 1e-5, "ref_logprobs")
        _close(a.token_rewards, b.token_rewards, 1e-6, "token_rewards")


def test_preprocessor_fused_equals_unfused():
    _, tcfg = _configs()
    _, tp = _pair_params(tcfg)
    outs = []
    for fused in (False, True):
        _, tr = _rollouts(4, seed=5, max_len=60)
        Preprocessor(dataclasses.replace(tcfg, fused_loss=fused), tp,
                     PreprocessConfig(max_len=64), device="cpu").process(tr)
        outs.append(tr)
    for a, b in zip(*outs):
        _close(a.ref_logprobs, b.ref_logprobs, 1e-5)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def _batches(n=3, lag=False):
    out = []
    for i in range(n):
        _, tr = _rollouts(7, seed=10 + i, versions=lag)
        out.append(pack(tr, batch=2, seq=64,
                        **(dict(trainer_version=3) if lag else {})))
    return out


@pytest.mark.parametrize("use_pallas", [False, True])
def test_three_trainer_steps_match_jax(use_pallas):
    """Fused loss on both sides (the JAX Pallas kernel in interpret mode
    with use_pallas, its blocked twin without): every metric and the params
    after each of three steps, from the same converted weights."""
    jcfg, tcfg = _configs(fused_loss=True)
    jcfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
    jp, tp = _pair_params(tcfg)
    jtr = JTrainer(jcfg, jp, adam=jadam.AdamConfig(**ADAM))
    ttr = Trainer(tcfg, tp, adam=AdamConfig(**ADAM), device="cpu")
    for step, batch in enumerate(_batches()):
        jm = dict(jtr.step(dict(batch)))
        tm = dict(ttr.step(dict(batch)))
        assert set(jm) == set(tm)
        for k in jm:
            _close(tm[k], jm[k], 1e-5, f"{k}, step {step}")
        assert ttr.version == jtr.version == step + 1
        _close_params(ttr.params, jtr.params, f"params after step {step}")


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """A checkpoint written by the JAX Trainer.save, restored by the port,
    gives the same next step; the port's own save writes the same keys."""
    jcfg, tcfg = _configs(fused_loss=True)
    jp, tp = _pair_params(tcfg)
    b1, b2 = _batches(2)
    jtr = JTrainer(jcfg, jp, adam=jadam.AdamConfig(**ADAM))
    jtr.step(dict(b1))
    path = jtr.save(str(tmp_path / "jax"))
    ttr = Trainer(tcfg, tp, adam=AdamConfig(**ADAM), device="cpu")
    assert ttr.restore(path) == 1
    jm, tm = dict(jtr.step(dict(b2))), dict(ttr.step(dict(b2)))
    for k in jm:
        _close(tm[k], jm[k], 1e-5, k)
    _close_params(ttr.params, jtr.params)
    mine = ttr.save(str(tmp_path / "port"))
    with np.load(path) as a, np.load(mine) as b:
        assert sorted(a.files) == sorted(b.files)
    # and the other way: the JAX trainer restores the port's checkpoint
    assert jtr.restore(mine) == 2
    for a, b in zip(tree_flatten(ttr.params)[0], jax.tree.leaves(jtr.params)):
        _close(a, b, 0.0)


def test_train_state_converts_both_ways():
    """The JAX TrainState as numpy converts into the port's, and the
    port's round-trips through numpy bit for bit."""
    from repro.core.trainer import init_train_state as jinit
    jcfg, tcfg = _configs()
    jp, tp = _pair_params(tcfg)
    jst = jax.tree.map(np.asarray, jinit(jp))
    conv = train_state_from_numpy(jst, tcfg, device="cpu")
    for a, b in zip(tree_flatten(conv)[0], jax.tree.leaves(jst)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    ttr = Trainer(tcfg, tp, adam=AdamConfig(**ADAM), device="cpu")
    ttr.step(_batches(1)[0])
    back = train_state_from_numpy(train_state_to_numpy(ttr.state), tcfg,
                                  device="cpu")
    for a, b in zip(tree_flatten(back)[0],
                    tree_flatten(ttr.state)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_round_trips_bf16(tmp_path):
    """A bfloat16 train state restores bit for bit, and a damaged file is
    refused by its checksum."""
    from repro_torch.checkpoint import checkpoint
    tcfg = dataclasses.replace(_configs()[1], dtype=torch.bfloat16)
    _, tp = _pair_params(tcfg)
    ttr = Trainer(tcfg, tp, adam=AdamConfig(**ADAM), device="cpu")
    ttr.step(_batches(1)[0])
    path = ttr.save(str(tmp_path / "bf16"))
    assert checkpoint.verify(path)
    back = checkpoint.load(path, ttr.state)
    for a, b in zip(tree_flatten(back)[0], tree_flatten(ttr.state)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    assert not checkpoint.verify(path)
    with pytest.raises(checkpoint.CheckpointError):
        checkpoint.load(path, ttr.state)


def _run(cfg, rl=algo.RLConfig(), guard=True, batches=None, poison=()):
    _, tp = _pair_params(cfg)
    tr = Trainer(cfg, tp, rl=rl, adam=AdamConfig(**ADAM), guard=guard,
                 device="cpu")
    ms = [dict(tr.step(dict(b), poison=i in poison))
          for i, b in enumerate(batches or _batches())]
    return tr, ms


def _bitwise(tr_a, tr_b):
    for a, b in zip(tree_flatten(tr_a.state)[0],
                    tree_flatten(tr_b.state)[0]):
        assert torch.equal(a, b)


def test_guarded_healthy_step_is_bitwise_unguarded():
    _, tcfg = _configs(fused_loss=True)
    a, ma = _run(tcfg, guard=True)
    b, mb = _run(tcfg, guard=False)
    _bitwise(a, b)
    for x, y in zip(ma, mb):
        assert x.pop("nonfinite") == 0.0 and x == y


def test_poisoned_step_leaves_the_state_bitwise():
    _, tcfg = _configs(fused_loss=True)
    batches = _batches(2)
    ref, _ = _run(tcfg, batches=batches[:1])
    tr, ms = _run(tcfg, batches=batches[:1] + batches[1:], poison=(1,))
    assert ms[1]["nonfinite"] == 1.0 and tr.last_nonfinite()
    assert tr.version == 1
    _bitwise(tr, ref)


@pytest.mark.parametrize("mode", ["token_is", "truncated"])
def test_armed_lag_modes_at_lag_zero_are_bitwise_off(mode):
    """Batches packed with trainer_version equal to every stamp (lag 0)."""
    _, tcfg = _configs(fused_loss=True)
    batches = []
    for i in range(2):
        _, tr = _rollouts(7, seed=20 + i)
        batches.append(pack(tr, batch=2, seq=64, trainer_version=0))
    off, m_off = _run(tcfg, batches=batches)
    armed, m_arm = _run(tcfg, rl=algo.RLConfig(lag_mode=mode),
                        batches=batches)
    _bitwise(off, armed)
    for a, b in zip(m_off, m_arm):
        assert all(a[k] == b[k] for k in a)


def test_remat_equals_no_remat():
    _, tcfg = _configs(fused_loss=True)
    a, ma = _run(tcfg)
    b, mb = _run(dataclasses.replace(tcfg, remat=True))
    _bitwise(a, b)
    assert ma == mb


def test_microbatch_matches_jax():
    """Gradient accumulation over 2 slices of the batch, against the JAX
    train_step with microbatch=2 (float32 accumulation on both sides)."""
    from repro.core.trainer import init_train_state as jinit
    from repro.core.trainer import train_step as jstep
    from repro_torch.core.trainer import init_train_state, train_step
    jcfg, tcfg = _configs(fused_loss=True)
    jp, tp = _pair_params(tcfg)
    host = {k: v for k, v in _batches(1)[0].items()
            if k not in ("packing_stats", "weight_versions")}
    batch = Trainer(tcfg, tp, device="cpu")._stage(host)
    one, tm = train_step(init_train_state(tp, device="cpu"), batch, tcfg,
                         algo.RLConfig(), AdamConfig(**ADAM), microbatch=2)
    jst, jm = jstep(jinit(jp), jax.tree.map(jnp.asarray, host), jcfg,
                    jalgo.RLConfig(), jadam.AdamConfig(**ADAM), microbatch=2)
    assert int(one.version) == int(jst.version) == 1
    for k in jm:
        _close(tm[k], jm[k], 1e-5, k)
    _close_params(one.params, jst.params)


def test_fetch_metrics_reads_the_history():
    _, tcfg = _configs(fused_loss=True)
    tr, ms = _run(tcfg)
    fetched = tr.fetch_metrics()
    assert len(fetched) == 3 and fetched == ms
