"""The port's EAGLE head trainers (`hsd_tpu_torch/train/`) against the JAX
package's (`hsd_tpu/train/`, optax 0.2.6), on the CPU in float32, at
`tests/test_train.py`'s sizes (a 4-layer 32-wide target, a 32-wide head).
Weights and optimizer states cross by `bridge`.

* multi_step_head_loss and eagle1_loss: the loss and every metric within
  1e-5, each trainable leaf's gradient within 1e-5 of its max |g|, against
  jax.value_and_grad (a reduced draft vocabulary, a ragged loss mask, and
  rope_scaling set: the training RoPE ignores it in both packages).
* The clip + AdamW + schedule fed JAX's gradients == optax's chain within
  1e-6 at every count, with and without the clip triggering.
* Three train steps of each head from `train_state_from_jax`, losses and
  params against JAX's. Tolerances: the v3 head, whose inputs are normed,
  within 1e-4 (loss, relative) and 2e-5 (params, absolute). The v1 head
  takes the target's raw final hidden state (std ~46 at this size) through
  fc with no norm, its attention saturates, and 75% of wq's gradient
  entries lie below 1e-6 of its max: there the f32 rounding of the two
  forwards decides the gradient's sign, and Adam turns that into a
  +-lr step. JAX against itself, with that hidden state perturbed by 1e-6
  (relative), moves the loss by 1.3e-3 and the params by up to 6.6e-3 over
  the same steps; so v1 is held within 5e-3 and 1e-2.
* Then every test of tests/test_train.py but the three on meshes (those
  are in tests/test_torch_train_dp.py): the loss decreases, frozen buffers
  stay, the checkpoint round trip (params and Adam moments bit-equal),
  online == offline, train_loop's resume, logging and epoch probe, the
  top-k metrics, the kacc probe; top_k_accuracy and getkacc with fixed
  probes equal to JAX's.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.engine.eagle_engine import default_feature_layers
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu.models.eagle import EagleConfig as JECfg
from hsd_tpu.models.eagle import init_eagle_params as j_init_eagle
from hsd_tpu.models.eagle import init_eagle_params_v1 as j_init_eagle_v1
from hsd_tpu.train import eagle1 as je1
from hsd_tpu.train import eagle3 as je3
from hsd_tpu.train import probes as jpr
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import ModelConfig
from hsd_tpu_torch.models.eagle import EagleConfig
from hsd_tpu_torch.train import eagle1 as te1
from hsd_tpu_torch.train import eagle3 as te3
from hsd_tpu_torch.train import probes as tpr
from hsd_tpu_torch.train.loop import train_loop
from hsd_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(2)

GEOM = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_layers=4, num_heads=4, num_kv_heads=2)
JTCFG = JCfg.tiny(**GEOM)
TCFG = ModelConfig.tiny(**GEOM)
EKW = dict(hidden_size=32, target_hidden_size=32, num_heads=4,
           num_kv_heads=2, vocab_size=64, draft_vocab_size=64,
           intermediate_size=64, rope_theta=10000.0)
JECFG = JECfg(dtype=jnp.float32, **EKW)
ECFG = EagleConfig(dtype=torch.float32, **EKW)
TC = te3.TrainConfig(steps=3, lr=2e-3, warmup_steps=2, total_steps=50)
FL = default_feature_layers(JTCFG)
SCALING = (8.0, 1.0, 4.0, 8)       # llama3 (factor, lo, hi, original max)


def _jtc(tc):
    return je3.TrainConfig(**dataclasses.asdict(tc))


def _ids(seed=2, B=2, T=16, V=64):
    return np.random.default_rng(seed).integers(0, V, (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    """(JAX target params, port target params, JAX v3 head, port v3 head)."""
    jt = j_init_params(JTCFG, jax.random.PRNGKey(0))
    je = j_init_eagle(JECFG, jax.random.PRNGKey(1))
    return (jt, bridge.params_from_jax(jt), je,
            bridge.eagle_params_from_jax(je))


def _draft_vocab(je, V=64, Vd=40, seed=3):
    """A reduced draft vocabulary on a head (lm_head cut to Vd columns)."""
    rng = np.random.default_rng(seed)
    top = np.sort(rng.choice(V, Vd, replace=False))
    t2d = np.zeros(V, bool)
    t2d[top] = True
    return je._replace(lm_head=je.lm_head[:, :Vd],
                       d2t=jnp.asarray(top - np.arange(Vd), jnp.int32),
                       t2d=jnp.asarray(t2d))


def _close_grads(tg: dict, jg: dict):
    for k, g in jg.items():
        if g is None:
            continue
        g = np.asarray(g)
        scale = max(float(np.abs(g).max()), 1e-30)
        err = float(np.abs(tg[k] - g).max())
        assert err <= 1e-5 * scale, (k, err, scale)


def _port_grads(params, loss):
    names = [k for k, _ in te3.trainable_leaves(params)]
    leaves = [v for _, v in te3.trainable_leaves(params)]
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {k: (np.zeros(v.shape, np.float32) if g is None
                else g.numpy()) for k, v, g in zip(names, leaves, gs)}


def _trainable(params):
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in te3.trainable_leaves(params)}


@pytest.mark.parametrize("case", ["full_vocab", "draft_vocab_ragged_mask",
                                  "rope_scaling"])
def test_multi_step_head_loss_matches_jax(pair, case):
    jt, tt, je, te = pair
    jecfg, ecfg = JECFG, ECFG
    if case != "full_vocab":
        je = _draft_vocab(je)
        te = bridge.eagle_params_from_jax(je)
        jecfg = dataclasses.replace(jecfg, draft_vocab_size=40)
        ecfg = dataclasses.replace(ecfg, draft_vocab_size=40)
    if case == "rope_scaling":
        jecfg = dataclasses.replace(jecfg, rope_scaling=SCALING)
        ecfg = dataclasses.replace(ecfg, rope_scaling=SCALING)
    B, T = 2, 16
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((B, T, 96)).astype(np.float32)
    tgt = (2.0 * rng.standard_normal((B, T, 64))).astype(np.float32)
    ids = _ids(6)
    lm = (np.ones((B, T), np.float32) if case == "full_vocab"
          else (rng.random((B, T)) < 0.7).astype(np.float32))
    steps = 4

    jtrain, jfrozen = je3._split_trainable(je)

    def jloss(tr):
        return je3.multi_step_head_loss(jecfg, je3._merge(tr, jfrozen),
                                        jnp.asarray(feats), jnp.asarray(tgt),
                                        jnp.asarray(ids), jnp.asarray(lm),
                                        steps)

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jtrain)
    tp = te._replace(**_trainable(te))
    tl, tm = te3.multi_step_head_loss(ecfg, tp, torch.from_numpy(feats),
                                      torch.from_numpy(tgt),
                                      torch.from_numpy(ids),
                                      torch.from_numpy(lm), steps)
    assert abs(tl.item() - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))
    assert set(tm) == set(jm)
    for k in jm:
        assert abs(tm[k].item() - float(jm[k])) <= 1e-5, k
    _close_grads(_port_grads(tp, tl), jg)


def test_training_rope_ignores_scaling_as_the_reference(pair):
    """The gap the port keeps (ROADMAP §3): with rope_scaling set, the
    training loss is the unscaled one exactly, while serving's head_forward
    rotates with the scaling."""
    from hsd_tpu_torch.models.eagle import head_forward, init_eagle_kv
    _, _, _, te = pair
    rng = np.random.default_rng(9)
    feats = torch.from_numpy(rng.standard_normal((1, 24, 96)).astype(
        np.float32))
    tgt = torch.from_numpy(rng.standard_normal((1, 24, 64)).astype(
        np.float32))
    ids = torch.from_numpy(_ids(1, 1, 24))
    lm = torch.ones((1, 24))
    scaled = dataclasses.replace(ECFG, rope_scaling=SCALING)
    with torch.no_grad():
        a, _ = te3.multi_step_head_loss(ECFG, te, feats, tgt, ids, lm, 2)
        b, _ = te3.multi_step_head_loss(scaled, te, feats, tgt, ids, lm, 2)
        assert float(a) == float(b)
        h = torch.randn((1, 24, 32),
                        generator=torch.Generator().manual_seed(0))
        pos = torch.arange(24)[None] + 500
        outs = [head_forward(c, te, h, h, init_eagle_kv(c, 1, 24, "cpu"),
                             pos)[0] for c in (ECFG, scaled)]
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("version", [1, 3])
def test_eagle1_loss_matches_jax(pair, version):
    """eagle1_loss on the v1 head (fc over cat(emb, hidden) + bias) and on a
    v3 head (as test_train.py's top-k test runs it); the v3 head's fc and
    norm get no gradient in either package."""
    jt, tt, je, te = pair
    jecfg = dataclasses.replace(JECFG, version=version)
    ecfg = dataclasses.replace(ECFG, version=version)
    if version == 1:
        je = j_init_eagle_v1(jecfg, jax.random.PRNGKey(4))
        je = je._replace(fc_b=0.1 * jax.random.normal(jax.random.PRNGKey(8),
                                                      je.fc_b.shape))
        te = bridge.eagle_params_from_jax(je)
    rng = np.random.default_rng(11)
    hidden = rng.standard_normal((2, 16, 32)).astype(np.float32)
    ids = _ids(12)
    lm = (rng.random((2, 16)) < 0.8).astype(np.float32)
    jtrain, jfrozen = je3._split_trainable(je)

    def jloss(tr):
        return je1.eagle1_loss(jecfg, je3._merge(tr, jfrozen),
                               jnp.asarray(hidden), jnp.asarray(ids),
                               jnp.asarray(lm))

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jtrain)
    tp = te._replace(**_trainable(te))
    tl, tm = te1.eagle1_loss(ecfg, tp, torch.from_numpy(hidden),
                             torch.from_numpy(ids), torch.from_numpy(lm))
    assert abs(tl.item() - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))
    assert set(tm) == set(jm)
    for k in jm:
        assert abs(tm[k].item() - float(jm[k])) <= 1e-5, k
    _close_grads(_port_grads(tp, tl), jg)


@pytest.mark.parametrize("warm,total", [(2, 50), (10, 11), (0, 7),
                                        (300, 1500)])
def test_schedule_matches_optax(warm, total):
    tc = te3.TrainConfig(lr=1.0, warmup_steps=warm, total_steps=total)
    ref = optax.warmup_cosine_decay_schedule(0.0, 1.0, warm, total)
    f = te3.lr_lambda(tc)
    for c in list(range(0, min(total, 40))) + [total // 2, total - 1,
                                                total, total + 3]:
        assert abs(f(c) - float(ref(c))) < 1e-6, c
    assert f(0) == 0.0 or warm == 0
    with pytest.raises(ValueError):
        te3.lr_lambda(te3.TrainConfig(warmup_steps=5, total_steps=5))


@pytest.mark.parametrize("gscale", [1e-3, 10.0], ids=["no_clip", "clip"])
def test_optimizer_matches_optax(pair, gscale):
    """Six steps of JAX's gradients through the port's clip + AdamW +
    LambdaLR (apply_update on a loss whose gradient is the given one) and
    through optax's chain: params, mu and nu within 1e-6 at every count.
    Leaf `norm` gets no gradient (the port fills zeros; optax decays it)."""
    _, _, je, te = pair
    tc = te3.TrainConfig(lr=3e-2, warmup_steps=2, total_steps=8)
    opt = je3.make_optimizer(_jtc(tc))
    jtrain, _ = je3._split_trainable(je)
    jstate = opt.init(jtrain)

    @jax.jit
    def jupdate(g, st, params):
        upd, st = opt.update(g, st, params)
        return optax.apply_updates(params, upd), st

    ts = te3.init_train_state(te, tc)
    rng = np.random.default_rng(21)
    for count in range(6):
        grads = {k: (None if v is None else
                     (gscale * rng.standard_normal(v.shape)).astype(
                         np.float32) * (k != "norm"))
                 for k, v in jtrain.items()}
        jg = {k: None if g is None else jnp.asarray(g)
              for k, g in grads.items()}
        jtrain, jstate = jupdate(jg, jstate, jtrain)
        loss = sum(torch.sum(p * torch.from_numpy(grads[k]))
                   for k, p in te3.trainable_leaves(ts.params)
                   if k != "norm")
        te3.apply_update(ts, tc, loss, {})
        adam = jstate[1][0]
        for k, p in te3.trainable_leaves(ts.params):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jtrain[k]), rtol=0,
                                       atol=1e-6, err_msg=f"{k} @ {count}")
            st = ts.opt.state[p]
            np.testing.assert_allclose(st["exp_avg"].numpy(),
                                       np.asarray(adam.mu[k]), rtol=0,
                                       atol=1e-6 * gscale)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                       np.asarray(adam.nu[k]), rtol=1e-5,
                                       atol=1e-9 * gscale ** 2)
        assert ts.step == count + 1 == int(adam.count)
    assert ts.opt.param_groups[0]["lr"] == pytest.approx(
        tc.lr * te3.lr_lambda(tc)(6))


@pytest.mark.parametrize("version,loss_tol,param_tol",
                         [(3, 1e-4, 2e-5), (1, 5e-3, 1e-2)])
def test_train_steps_from_jax_state(pair, version, loss_tol, param_tol):
    """One JAX step, the state across by train_state_from_jax, then three
    steps in each package on the same batches (the tolerances: see the
    module's docstring)."""
    jt, tt, je, te = pair
    jecfg = dataclasses.replace(JECFG, version=version)
    ecfg = dataclasses.replace(ECFG, version=version)
    if version == 1:
        je = j_init_eagle_v1(jecfg, jax.random.PRNGKey(4))
        jstep = je1.make_eagle1_train_step(JTCFG, jecfg, _jtc(TC))
        tstep = te1.make_eagle1_train_step(TCFG, ecfg, TC)
    else:
        jstep = je3.make_train_step(JTCFG, jecfg, _jtc(TC), FL)
        tstep = te3.make_train_step(TCFG, ecfg, TC, FL)
    lm = np.ones((2, 16), np.float32)
    js, _ = jstep(je3.init_train_state(je, _jtc(TC)), jt,
                  jnp.asarray(_ids(30)), jnp.asarray(lm))
    ts = bridge.train_state_from_jax(js, TC)
    assert ts.step == 1 and ts.opt.param_groups[0]["lr"] == pytest.approx(
        TC.lr * 0.5)
    worst = 0.0
    for i in range(3):
        ids = _ids(31 + i)
        js, jm = jstep(js, jt, jnp.asarray(ids), jnp.asarray(lm))
        ts, tm = tstep(ts, tt, ids, lm)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= loss_tol * abs(
            float(jm["loss"])), (i, float(tm["loss"]), float(jm["loss"]))
        for k, p in te3.trainable_leaves(ts.params):
            worst = max(worst, float(np.abs(p.detach().numpy() - np.asarray(
                getattr(js.params, k))).max()))
    assert ts.step == int(js.step) == 4
    assert worst <= param_tol, worst


def _setup(tt, te, tc=TC):
    state = te3.init_train_state(te, tc)
    step = te3.make_train_step(TCFG, ECFG, tc, FL)
    return state, step, _ids(2), np.ones((2, 16), np.float32)


def test_loss_decreases(pair):
    _, tt, _, te = pair
    state, step, ids, lm = _setup(tt, te)
    losses = []
    for _ in range(8):
        state, metrics = step(state, tt, ids, lm)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses
    assert state.step == 8
    assert np.isfinite(losses).all()


def test_frozen_buffers_untouched(pair):
    _, tt, _, te = pair
    te = te._replace(d2t=torch.zeros(64, dtype=torch.int64))
    state, step, ids, lm = _setup(tt, te)
    before = {k: getattr(state.params, k).clone() for k in te3.FROZEN}
    fc0 = te.fc.clone()
    for _ in range(2):
        state, _ = step(state, tt, ids, lm)
    for k in te3.FROZEN:
        assert torch.equal(getattr(state.params, k), before[k]), k
        assert not getattr(state.params, k).requires_grad
    assert torch.equal(te.fc, fc0)            # the caller's head stays
    assert not torch.equal(state.params.fc.detach(), fc0)
    assert state.params.fc_b is None


def test_checkpoint_roundtrip(pair, tmp_path):
    _, tt, _, te = pair
    state, step, ids, lm = _setup(tt, te)
    state, _ = step(state, tt, ids, lm)
    te3.save_checkpoint(str(tmp_path), state)
    assert te3.latest_checkpoint_step(str(tmp_path)) == 1
    assert (tmp_path / "state_1").is_dir()
    restored = te3.restore_checkpoint(str(tmp_path), 1,
                                      te3.init_train_state(te, TC))
    assert restored.step == 1
    for (k, p), (_, q) in zip(te3.trainable_leaves(state.params),
                              te3.trainable_leaves(restored.params)):
        assert torch.equal(p, q), k
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(state.opt.state[p][m],
                               restored.opt.state[q][m]), (k, m)
    assert restored.opt.param_groups[0]["lr"] == state.opt.param_groups[0][
        "lr"]
    # the next step continues identically
    s1, m1 = step(state, tt, ids, lm)
    s2, m2 = step(restored, tt, ids, lm)
    assert float(m1["loss"]) == float(m2["loss"])
    assert torch.equal(s1.params.wq, s2.params.wq)


def test_offline_features_step_matches_online(pair, tmp_path):
    """The port's dump, then its offline step == its online step modulo the
    f16 shard round trip (test_train.py's tolerances)."""
    from hsd_tpu_torch.train.features import (dump_features,
                                              offline_data_epochs)
    _, tt, _, te = pair
    state, step, ids, lm = _setup(tt, te)
    s1, m1 = step(state, tt, ids, lm)
    d = str(tmp_path / "feats")
    assert dump_features(TCFG, tt, [(ids, lm)], d, feature_layers=FL,
                         version=3, device="cpu") == 1
    batches = list(offline_data_epochs(d, device="cpu")(0))
    assert len(batches) == 1
    ostep = te3.make_train_step_offline(TCFG, ECFG, TC)
    s2, m2 = ostep(te3.init_train_state(te, TC), None, **batches[0])
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=2e-3)
    np.testing.assert_allclose(s1.params.fc.detach().numpy(),
                               s2.params.fc.detach().numpy(), rtol=2e-2,
                               atol=1e-4)


def test_offline_features_eagle1_step(pair, tmp_path):
    from hsd_tpu_torch.models.eagle import init_eagle_params_v1
    from hsd_tpu_torch.train.features import (dump_features,
                                              offline_data_epochs)
    _, tt, _, _ = pair
    ecfg1 = dataclasses.replace(ECFG, version=1)
    pe = init_eagle_params_v1(ecfg1, seed=1, device="cpu")
    ids, lm = _ids(2), np.ones((2, 16), np.float32)
    s1, m1 = te1.make_eagle1_train_step(TCFG, ecfg1, TC)(
        te3.init_train_state(pe, TC), tt, ids, lm)
    d = str(tmp_path / "feats1")
    dump_features(TCFG, tt, [(ids, lm)], d, version=1, device="cpu")
    batch = next(iter(offline_data_epochs(d, device="cpu")(0)))
    s2, m2 = te1.make_eagle1_train_step_offline(TCFG, ecfg1, TC)(
        te3.init_train_state(pe, TC), None, **batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=2e-3)


def test_eagle1_loss_decreases(pair):
    from hsd_tpu_torch.models.eagle import init_eagle_params_v1
    _, tt, _, _ = pair
    ecfg1 = dataclasses.replace(ECFG, version=1)
    state = te3.init_train_state(
        init_eagle_params_v1(ecfg1, seed=1, device="cpu"), TC)
    step = te1.make_eagle1_train_step(TCFG, ecfg1, TC)
    ids, lm = _ids(2), np.ones((2, 16), np.float32)
    losses = []
    for _ in range(8):
        state, m = step(state, tt, ids, lm)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_train_loop_resume_and_logging(pair, tmp_path):
    """Runs epochs, writes JSONL metrics, checkpoints, and a second
    invocation auto-resumes without redoing consumed steps."""
    _, tt, _, te = pair
    state, step, ids, lm = _setup(tt, te)

    def data(epoch):
        return [(ids, lm)] * 3

    logger = MetricLogger(path=str(tmp_path / "metrics.jsonl"))
    out = train_loop(state, step, tt, data, num_epochs=2,
                     ckpt_dir=str(tmp_path / "ckpt"), logger=logger,
                     log_every=2)
    logger.close()
    assert out.step == 6
    assert te3.latest_checkpoint_step(str(tmp_path / "ckpt")) == 6
    rows = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [2, 4, 6]
    assert all("loss" in r for r in rows)

    # resume: 2 more epochs on top -> replay-skips the first 6 batches
    calls = []

    def counting(state, pt, i, m):
        calls.append(1)
        return step(state, pt, i, m)

    out2 = train_loop(te3.init_train_state(out.params, TC), counting, tt,
                      data, num_epochs=4, ckpt_dir=str(tmp_path / "ckpt"))
    assert out2.step == 12 and len(calls) == 6
    assert te3.latest_checkpoint_step(str(tmp_path / "ckpt")) == 12


def test_topk_metrics_in_trainers(pair):
    _, tt, _, te = pair
    state, step, ids, lm = _setup(tt, te)
    _, m3 = step(state, tt, ids, lm)
    for k in ("top1_acc", "top2_acc", "top3_acc"):
        assert k in m3, m3.keys()
    assert float(m3["top1_acc"]) <= float(m3["top2_acc"]) + 1e-6
    assert float(m3["top2_acc"]) <= float(m3["top3_acc"]) + 1e-6
    step1 = te1.make_eagle1_train_step(TCFG, ECFG, TC)
    _, m1 = step1(te3.init_train_state(te, TC), tt, ids, lm)
    for k in ("top1_acc", "top2_acc", "top3_acc"):
        assert k in m1
    assert float(m1["top1_acc"]) <= float(m1["top3_acc"]) + 1e-6


def test_top_k_accuracy_matches_jax():
    rng = np.random.default_rng(40)
    pred = rng.standard_normal((3, 7, 50)).astype(np.float32)
    tgt = rng.standard_normal((3, 7, 50)).astype(np.float32)
    m = (rng.random((3, 7)) < 0.6).astype(np.float32)
    j = jpr.top_k_accuracy(jnp.asarray(pred), jnp.asarray(tgt),
                           jnp.asarray(m), ks=(1, 2, 5))
    t = tpr.top_k_accuracy(torch.from_numpy(pred), torch.from_numpy(tgt),
                           torch.from_numpy(m), ks=(1, 2, 5))
    assert set(j) == set(t)
    for k in j:
        assert abs(float(j[k]) - float(t[k])) < 1e-6, k


def test_getkacc_matches_jax(pair):
    """The rollout tokens, the target's argmax chain and kacc equal JAX's
    with fixed probes (a reduced draft vocabulary, a ragged mask)."""
    _, _, je, _ = pair
    je = _draft_vocab(je)
    te = bridge.eagle_params_from_jax(je)
    jecfg = dataclasses.replace(JECFG, draft_vocab_size=40)
    ecfg = dataclasses.replace(ECFG, draft_vocab_size=40)
    rng = np.random.default_rng(50)
    hidden = rng.standard_normal((2, 20, 32)).astype(np.float32)
    ids = _ids(51, 2, 20)
    lm = (rng.random((2, 20)) < 0.85).astype(np.float32)
    probes = np.array([1, 4, 9, 13], np.int32)
    jroll = jax.jit(jpr._rollout, static_argnums=(0, 5))
    jr, jt_ = jroll(jecfg, je, jnp.asarray(hidden), jnp.asarray(ids),
                    jnp.asarray(probes), 4)
    tr, tt_ = tpr._rollout(ecfg, te, torch.from_numpy(hidden),
                           torch.from_numpy(ids).long(),
                           torch.from_numpy(probes).long(), 4)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tt_.numpy(), np.asarray(jt_))
    jk = jpr.getkacc(jecfg, je, jnp.asarray(hidden), jnp.asarray(ids),
                     jnp.asarray(lm), max_length=4, probes=probes)
    tk = tpr.getkacc(ecfg, te, torch.from_numpy(hidden), ids, lm,
                     max_length=4, probes=probes)
    np.testing.assert_array_equal(tk, jk)


def test_kacc_probe(pair):
    """Bounds, and both head versions run (test_train.py's)."""
    from hsd_tpu_torch.models.eagle import init_eagle_params_v1
    _, tt, _, te = pair
    ids, lm = _ids(2), np.ones((2, 16), np.float32)
    m = tpr.make_kacc_probe(TCFG, ECFG, max_length=4, max_probes=6)(
        te, tt, ids, lm)
    assert all(0.0 <= m[f"kacc_{i}"] <= 1.0 for i in range(4)), m
    ecfg1 = dataclasses.replace(ECFG, version=1)
    pe1 = init_eagle_params_v1(ecfg1, seed=7, device="cpu")
    m1 = tpr.make_kacc_probe(TCFG, ecfg1, max_length=3, max_probes=4)(
        pe1, tt, ids, lm)
    assert all(0.0 <= m1[f"kacc_{i}"] <= 1.0 for i in range(3))


def test_kacc_chain_property(pair):
    """kacc_0 >= kacc_last on an untrained head (chained accounting)."""
    from hsd_tpu_torch.engine.kvcache import init_cache
    from hsd_tpu_torch.models import transformer
    from hsd_tpu_torch.ops.linear import apply_linear
    _, tt, _, te = pair
    ids = torch.from_numpy(_ids(2)).long()
    with torch.no_grad():
        _, _, feats = transformer.forward(TCFG, tt, ids,
                                          init_cache(TCFG, 2, 16, "cpu"),
                                          feature_layers=FL)
        hidden = apply_linear(te.fc, feats)
    kacc = tpr.getkacc(ECFG, te, hidden, ids, np.ones((2, 16), np.float32),
                       max_length=4, max_probes=8)
    assert kacc.shape == (4,)
    assert (kacc >= 0).all() and (kacc <= 1).all()
    assert kacc[0] >= kacc[-1] - 1e-9


def test_train_loop_epoch_probe(pair, tmp_path):
    """The between-epoch kacc evaluation runs on probe_batches batches and
    logs eval/-prefixed means."""
    _, tt, _, te = pair
    state, step, ids, lm = _setup(tt, te)
    probe = tpr.make_kacc_probe(TCFG, ECFG, max_length=3, max_probes=4)
    seen = []

    def counted(*a):
        seen.append(1)
        return probe(*a)

    logger = MetricLogger(path=str(tmp_path / "m.jsonl"))
    train_loop(state, step, tt, lambda e: [(ids, lm)] * 3, num_epochs=1,
               logger=logger, log_every=1, epoch_probe=counted,
               probe_batches=2)
    logger.close()
    assert len(seen) == 2
    rows = [json.loads(l) for l in open(tmp_path / "m.jsonl")]
    eval_rows = [r for r in rows if any(k.startswith("eval/") for k in r)]
    assert len(eval_rows) == 1, rows
    for i in range(3):
        assert 0.0 <= eval_rows[0][f"eval/kacc_{i}"] <= 1.0


def test_plot_summary(tmp_path):
    from hsd_tpu_torch.eval.metrics import plot_summary
    s = {"tokenwise": {"block_efficiency": 5.9, "decoding_speed": 82.0},
         "hsd": {"block_efficiency": 6.3, "decoding_speed": 91.0}}
    p = plot_summary(s, str(tmp_path / "be.png"))
    assert p is None or (tmp_path / "be.png").exists()


def test_step_needs_no_grad_on_the_target(pair, monkeypatch):
    """The frozen target's forward runs with autograd off: no tensor that
    reaches a product of the target needs a gradient (the hand kernels have
    no backward)."""
    from hsd_tpu_torch.models import transformer
    _, tt, _, te = pair
    state, step, ids, lm = _setup(tt, te)
    real = transformer.forward
    seen = []

    def spy(*a, **k):
        seen.append(torch.is_grad_enabled())
        return real(*a, **k)

    monkeypatch.setattr(transformer, "forward", spy)
    step(state, tt, ids, lm)
    assert seen == [False]


@pytest.mark.slow
def test_trained_head_be_matches_jax_per_mode():
    """`realistic_eagle`'s question at a tiny size, with both packages on
    the same trained models: a 2-layer 64-wide target trained by JAX's
    oracle and an EAGLE-3 head trained by JAX's make_train_step, both
    bridged; then typical, hsd and hsd_ref through each package's
    make_eagle_generate, 32 runs x 64 tokens a mode. The verifiers keep
    the target's law and each package draws its own noise, so each mode's
    BE must agree within 4 standard errors; the order of the modes is
    then the models', not the port's. Prints the BEs."""
    from hsd_tpu.config import EngineConfig as JEng
    from hsd_tpu.engine.eagle_engine import make_eagle_generate as j_gen
    from hsd_tpu.eval import oracle as jo
    from hsd_tpu_torch.config import EngineConfig
    from hsd_tpu_torch.engine.eagle_engine import make_eagle_generate

    V, P, new, runs = 256, 16, 64, 32
    geom = dict(vocab_size=V, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, num_kv_heads=2,
                tie_word_embeddings=False, eos_token_id=V - 1)
    jcfg, tcfg = JCfg.tiny(**geom), ModelConfig.tiny(**geom)
    lang = jo.make_language(jax.random.PRNGKey(3), vocab=V, n_words=80)
    jt, _ = jo.train_lm(jcfg, jax.random.PRNGKey(4), lang, steps=300,
                        batch=16, seq=48, chunk=300)
    ekw = dict(hidden_size=64, target_hidden_size=64, num_heads=4,
               num_kv_heads=2, vocab_size=V, draft_vocab_size=V,
               intermediate_size=128, top_k=10, depth=6, total_tokens=59,
               rope_theta=JTCFG.rope_theta)
    jecfg = JECfg(dtype=jnp.float32, **ekw)
    ecfg = EagleConfig(dtype=torch.float32, **ekw)
    jtc = je3.TrainConfig(steps=3, lr=2e-3, warmup_steps=30,
                          total_steps=300, max_len=48)
    js = je3.init_train_state(j_init_eagle(jecfg, jax.random.PRNGKey(5)),
                              jtc)
    jstep = je3.make_train_step(jcfg, jecfg, jtc,
                                default_feature_layers(jcfg))
    lm = jnp.ones((16, 48), jnp.float32)
    for i in range(300):
        ids = jo.sample_tokens(jax.random.fold_in(jax.random.PRNGKey(6), i),
                               lang, 16, 48).astype(jnp.int32)
        js, jm = jstep(js, jt, ids, lm)
    tt = bridge.params_from_jax(jt)
    te = bridge.eagle_params_from_jax(js.params)
    prompts = np.asarray(jo.sample_tokens(jax.random.PRNGKey(7), lang, 8, P))
    out = {}
    for mode in ("typical", "hsd", "hsd_ref"):
        jg = j_gen(jcfg, jecfg, JEng(max_new_tokens=new, temperature=1.0),
                   mode=mode)
        tg = make_eagle_generate(tcfg, ecfg, EngineConfig(
            max_new_tokens=new, temperature=1.0), mode=mode)
        jb, tb = [], []
        for r in range(runs):
            p = prompts[r % 8]
            res = jg(jt, js.params, jnp.asarray(p, jnp.int32), jnp.int32(P),
                     jax.random.PRNGKey(100 + r))
            jb += (np.asarray(res.accepts)[:int(res.blocks)] + 1).tolist()
            res = tg(tt, te, torch.tensor(p, dtype=torch.int64), P,
                     torch.Generator().manual_seed(100 + r))
            tb += (res.accepts[:res.blocks] + 1).tolist()
        se = (np.var(jb) / len(jb) + np.var(tb) / len(tb)) ** 0.5
        out[mode] = (float(np.mean(jb)), float(np.mean(tb)), float(se))
        print(f"{mode}: JAX BE {out[mode][0]:.4f}, port {out[mode][1]:.4f} "
              f"(SE of the difference {se:.4f}); head acc_0 "
              f"{float(jm['acc_0']):.3f}")
    for mode, (j, t, se) in out.items():
        assert abs(j - t) <= 4 * se, (mode, out)
