"""The port's realistic oracle pair (`hsd_tpu_torch/eval/oracle.py`)
against the JAX package's (`hsd_tpu/eval/oracle.py`, optax 0.2.6).

* make_language: bit for bit the JAX language from the same int (the JAX
  code seeds numpy with its key's last word), the realistic row's too.
* The schedule and AdamW: the LambdaLR factor equals
  optax.warmup_cosine_decay_schedule at every count; three AdamW steps on
  the same gradients equal optax.adamw's within 1e-6.
* One CE loss and its gradients, and one soft-CE (distillation) loss and
  its gradients, through the port's forward (its cache writes in place)
  against jax.value_and_grad on bridged params and the same ids: within
  1e-5 of each gradient's scale; every parameter gets a gradient.
* sample_tokens draws the JAX sampler's token law; scale_draft_temperature
  as JAX's; train_lm / distill_lm lower their losses; ratio_stats has
  JAX's keys.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.engine.kvcache import init_cache as j_init_cache
from hsd_tpu.eval import oracle as jo
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu.models import transformer as jtf
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import ModelConfig
from hsd_tpu_torch.eval import oracle as to

torch.set_num_threads(2)

GEOM = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2,
            tie_word_embeddings=False, eos_token_id=63)
JCFG = JCfg.tiny(**GEOM)
TCFG = ModelConfig.tiny(**GEOM)
# the last word of bench.py's realistic-row language key,
# fold_in(fold_in(PRNGKey(0), 40), 31)
REALISTIC_LANG_SEED = 3592766398


def _lang_equal(t, j):
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed,kw", [(0, {}), (5, {}),
                                     (7, dict(vocab=64, n_words=30))])
def test_make_language_bitwise(seed, kw):
    _lang_equal(to.make_language(seed, device="cpu", **kw),
                jo.make_language(jax.random.PRNGKey(seed), **kw))


def test_make_language_of_a_folded_key():
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 40),
                             31)
    assert int(jax.random.key_data(key)[-1]) == REALISTIC_LANG_SEED
    _lang_equal(to.make_language(REALISTIC_LANG_SEED, device="cpu"),
                jo.make_language(key))


@pytest.mark.parametrize("steps", [20, 200, 1800])
def test_schedule_matches_optax(steps):
    ref = optax.warmup_cosine_decay_schedule(0.0, 1.0, max(10, steps // 20),
                                             steps)
    f = to.lr_lambda(steps)
    for c in list(range(0, min(steps, 60))) + [steps // 2, steps - 1,
                                                steps, steps + 5]:
        assert abs(f(c) - float(ref(c))) < 1e-6, c
    assert f(0) == 0.0


def test_adamw_steps_match_optax():
    """Three steps on the same gradients: the step-0 update is zero (lr 0
    at the pre-increment count), then warmup; weight decay 0.01 scaled by
    the schedule's lr, eps outside the sqrt, as optax.adamw."""
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal((5, 7)).astype(np.float32),
          rng.standard_normal((7,)).astype(np.float32)]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in p0]
             for _ in range(3)]
    lr, steps = 3e-3, 20
    opt = jo._make_opt(lr, steps)
    jp = [jnp.asarray(p) for p in p0]
    state = opt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    topt, sched = to.make_optimizer(tp, lr, steps)
    for g in grads:
        upd, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for t, x in zip(tp, g):
            t.grad = torch.from_numpy(x)
        topt.step()
        sched.step()
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                       atol=1e-6)
    assert not np.array_equal(tp[0].numpy(), p0[0])


def _bridged(seed=0):
    jp = j_init_params(JCFG, jax.random.PRNGKey(seed))
    return jp, bridge.params_from_jax(jp)


def _ids(seed=1, B=3, T=12):
    return np.random.default_rng(seed).integers(0, 64, (B, T)).astype(
        np.int32)


def _check_grads(jgrads, leaves):
    want = to.param_leaves(bridge.params_from_jax(jgrads))
    assert len(want) == len(leaves)
    for w, t in zip(want, leaves):
        assert t.grad is not None
        assert float(t.grad.abs().sum()) > 0
        scale = max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(t.grad.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * scale)


def test_ce_loss_and_grads_match_jax():
    jp, tp = _bridged()
    ids = _ids()
    B, T = ids.shape

    def loss_fn(p):
        logits, _ = jtf.forward(JCFG, p, jnp.asarray(ids),
                                j_init_cache(JCFG, B, T))
        lp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
        return -jnp.take_along_axis(lp, jnp.asarray(ids)[:, 1:, None],
                                    -1).mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(jp)
    leaves = to.param_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss = to.ce_loss(TCFG, tp, torch.from_numpy(ids).long())
    loss.backward()
    assert abs(loss.item() - float(jloss)) < 1e-5
    _check_grads(jgrads, leaves)


def test_soft_ce_loss_and_grads_match_jax():
    jpd, tpd = _bridged(0)
    jpt, tpt = _bridged(3)
    ids = _ids(2)
    B, T = ids.shape
    tl, _ = jtf.forward(JCFG, jpt, jnp.asarray(ids), j_init_cache(JCFG, B, T))
    jtp = jax.nn.softmax(tl.astype(jnp.float32), -1)

    def loss_fn(p):
        logits, _ = jtf.forward(JCFG, p, jnp.asarray(ids),
                                j_init_cache(JCFG, B, T))
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        return -jnp.mean(jnp.sum(jtp * lp, -1))

    jloss, jgrads = jax.value_and_grad(loss_fn)(jpd)
    leaves = to.param_leaves(tpd)
    for t in leaves:
        t.requires_grad_(True)
    loss = to.soft_ce_loss(TCFG, tpd, torch.from_numpy(np.asarray(jtp)),
                           torch.from_numpy(ids).long())
    loss.backward()
    assert abs(loss.item() - float(jloss)) < 1e-5
    _check_grads(jgrads, leaves)


def test_sample_tokens_law_matches_jax():
    """Unigram and bigram laws of the two samplers on a small language
    (32768 tokens each): TV within sampling noise."""
    jl = jo.make_language(jax.random.PRNGKey(4), vocab=32, n_words=20)
    tl = to.make_language(4, vocab=32, n_words=20, device="cpu")
    jt = np.asarray(jo.sample_tokens(jax.random.PRNGKey(9), jl, 512, 64))
    tt = to.sample_tokens(torch.Generator().manual_seed(9), tl, 512, 64)
    assert tt.shape == (512, 64) and tt.dtype == torch.int64
    tt = tt.numpy()
    assert (tt > 0).all() and set(np.unique(tt)) <= set(
        tl.words.numpy().ravel())

    def tv(a, b, n):
        pa = np.bincount(a, minlength=n) / len(a)
        pb = np.bincount(b, minlength=n) / len(b)
        return 0.5 * np.abs(pa - pb).sum()

    assert tv(tt.ravel(), jt.ravel(), 32) < 0.03
    big = lambda x: (x[:, :-1] * 32 + x[:, 1:]).ravel()
    assert tv(big(tt), big(jt), 32 * 32) < 0.08


def test_scale_draft_temperature_matches_jax():
    jp, tp = _bridged()
    out = to.scale_draft_temperature(tp, TCFG, 1.37)
    want = jo.scale_draft_temperature(jp, JCFG, 1.37)
    np.testing.assert_array_equal(out.lm_head.numpy(),
                                  np.asarray(want.lm_head))
    assert out.embed is tp.embed
    tied = ModelConfig.tiny(**dict(GEOM, tie_word_embeddings=True))
    with pytest.raises(ValueError, match="tied"):
        to.scale_draft_temperature(tp._replace(lm_head=None), tied, 2.0)


def test_train_distill_and_ratio_stats_smoke():
    """train_lm and distill_lm at a tiny size: each loss falls from its
    first step, the parameters come back frozen, ratio_stats has JAX's
    keys and a temperature above 1 lowers the implied BE."""
    lang = to.make_language(3, vocab=64, n_words=30, device="cpu")
    small = ModelConfig.tiny(**dict(GEOM, hidden_size=16,
                                    intermediate_size=32, num_layers=1))
    tl, dl = [], []
    pt, tce = to.train_lm(TCFG, 1, lang, steps=40, batch=8, seq=24,
                          device="cpu", losses=tl)
    pd, dce = to.distill_lm(small, TCFG, pt, 2, lang, steps=40, batch=8,
                            seq=24, device="cpu", losses=dl)
    assert len(tl) == len(dl) == 40 and tce == tl[-1] and dce == dl[-1]
    assert tce < tl[0] - 0.3 and dce < dl[0] - 0.3, (tl, dl)
    assert all(math.isfinite(x) for x in tl + dl)
    assert not any(t.requires_grad for t in to.param_leaves(pt))
    st = to.ratio_stats(small, TCFG, pd, pt, lang,
                        torch.Generator().manual_seed(0), batch=8, seq=24)
    jl = jo.make_language(jax.random.PRNGKey(3), vocab=64, n_words=30)
    jpt, _ = _bridged()
    jst = jo.ratio_stats(JCFG, JCFG, jpt, jpt, jl, jax.random.PRNGKey(0),
                         batch=2, seq=8)
    assert set(st) == set(jst)
    assert 0 < st["alpha"] <= 1 and len(st["logratio_hist_-8_2"]) == 10
    hot = to.ratio_stats(small, TCFG, to.scale_draft_temperature(
        pd, small, 3.0), pt, lang, torch.Generator().manual_seed(0),
        batch=8, seq=24)
    assert hot["implied_tokenwise_be"] < st["implied_tokenwise_be"]
