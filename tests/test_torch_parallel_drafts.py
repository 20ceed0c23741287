"""The parallel multidraft drafter (VerifierConfig(parallel=True), K rows)
of the port against the JAX package.

* `draft_rows(..., striped=False)` against JAX's `_draft_block` on a
  bridged 2-layer f32 model, fed the Gumbel draws JAX's drafter makes
  (`split(key, gamma)[j]`, one categorical over the [K, V] rows of step j,
  which `jax.random.categorical` turns into `gumbel(key_j, (K, V))`):
  tokens equal, q within 1e-5, the cache lengths equal and every row's
  cache entries within 1e-5 of the buffer's largest magnitude.
* The two packages' mean accepts (hsd, gamma 10) at K = 1 and K = 11 on
  one bridged tiny pair, over 128 runs (and, under `-m slow`, 1024, where
  each CI95 is about 0.1): the port's means and its K = 1 -> 11 gain lie
  within the CIs of JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.config import EngineConfig as JEng
from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.config import VerifierConfig as JVer
from hsd_tpu.engine import kvcache as jkv
from hsd_tpu.engine import make_generate as j_make_generate
from hsd_tpu.engine import speculative as jspec
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu.models import transformer as jtf
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine.speculative import draft_rows, make_generate_batched
from hsd_tpu_torch.ops.sampling import processor

torch.set_num_threads(2)

JCFG = JCfg.tiny(vocab_size=64)
TCFG = ModelConfig.tiny(vocab_size=64)


@pytest.mark.parametrize("K", [2, 11])
def test_draft_block_parallel_matches_jax(K):
    """Same weights, same prompt, the same Gumbel draws: the port's
    parallel drafter gives JAX's tokens, q and cache."""
    gamma, P, plen = 10, 12, 9
    jp = j_init_params(JCFG, jax.random.PRNGKey(0))
    prompt = (np.arange(P) % 50 + 1).astype(np.int32)
    S = P + gamma + 4
    start = jnp.full((K,), P - plen, jnp.int32)
    jc = jkv.init_cache(JCFG, K, S)._replace(start=start)
    _, jc = jtf.forward(JCFG, jp, jnp.broadcast_to(prompt[None, :-2],
                                                   (K, P - 2)), jc)
    key = jax.random.PRNGKey(7)
    temp = 1.0
    jt, jq, jc2 = jspec._draft_block(
        JCFG, jp, jc, jnp.int32(prompt[-2]), jnp.int32(prompt[-1]), key,
        gamma, temp)
    # the draws JAX's drafter makes: split(key, gamma)[j] for step j, one
    # categorical over all K rows, i.e. gumbel(key_j, (K, V))
    noise = torch.from_numpy(np.stack([
        np.asarray(jax.random.gumbel(kj, (K, JCFG.vocab_size), jnp.float32))
        for kj in jax.random.split(key, gamma)]))

    tp = bridge.params_from_jax(jp)
    tc = bridge.cache_from_jax(jc)
    pt = torch.from_numpy(prompt).long()
    tt, tq, tc2 = draft_rows(TCFG, tp, tc, pt[-2], pt[-1], gamma, K, False,
                             processor(temp), None, noise=lambda j: noise[j])
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5,
                               rtol=0)
    assert tc2.length == int(jc2.length) == P - 2 + gamma + 1
    # the rows really differ: K independent drafts, not one draft K times
    assert len({tuple(r) for r in tt.tolist()}) > 1
    for tbuf, jbuf in ((tc2.k, jc2.k), (tc2.v, jc2.v)):
        jbuf = np.asarray(jbuf)
        np.testing.assert_allclose(tbuf.numpy(), jbuf, rtol=0,
                                   atol=1e-5 * float(np.abs(jbuf).max()))


# the acceptance comparison: a bridged tiny pair whose draft and target are
# one model with sharpened embeddings (x 16 and x 20: a real divergence,
# mean accepts ~6.7 of 10 at K = 1)
ACC_CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
               num_layers=2, num_heads=4, num_kv_heads=2)
ACC_NEW, ACC_GAMMA, ACC_PLEN = 128, 10, 16


def _per_run_stats(accepts, blocks):
    """(mean, CI95) over runs of each run's mean accepts."""
    per_run = np.asarray([np.mean(a[:b]) for a, b in zip(accepts, blocks)])
    return (float(per_run.mean()),
            1.96 * float(per_run.std(ddof=1)) / np.sqrt(len(per_run)))


@pytest.mark.parametrize("runs", [pytest.param(1024, marks=pytest.mark.slow),
                                  128])
def test_k11_acceptance_gain_matches_jax(runs):
    """hsd's mean accepts at K = 1 and K = 11 on one bridged pair, `runs`
    sampled runs a package (JAX: make_generate vmapped over keys; the port:
    make_generate_batched, whose rows are make_generate's on their
    generators): the sampled streams differ, so the packages are compared
    by their means. Each of the port's lies within 1.5x the CI95 of the
    difference from JAX's, and so does its K = 1 -> 11 gain. At 1024 runs
    each CI95 is about 0.1."""
    jcfg, tcfg = JCfg.tiny(**ACC_CFG), ModelConfig.tiny(**ACC_CFG)
    base = j_init_params(jcfg, jax.random.PRNGKey(0))
    jd = base._replace(embed=base.embed * 16)
    jt = base._replace(embed=base.embed * 20)
    pd, pt = bridge.params_from_jax(jd), bridge.params_from_jax(jt)
    prompt = (np.arange(ACC_PLEN) % 50 + 3).astype(np.int32)
    prompts = torch.from_numpy(prompt).long()[None].expand(runs, ACC_PLEN)
    out = {}
    for K in (1, 11):
        v = dict(method="hsd", gamma=ACC_GAMMA, num_drafts=K)
        jgen = j_make_generate(jcfg, jcfg, JEng(
            verifier=JVer(**v), max_new_tokens=ACC_NEW, temperature=1.0))
        jres = jax.jit(jax.vmap(lambda k: jgen(
            jd, jt, jnp.asarray(prompt), jnp.int32(ACC_PLEN), k)))(
                jax.random.split(jax.random.PRNGKey(5), runs))
        out[("jax", K)] = _per_run_stats(np.asarray(jres.accepts),
                                         np.asarray(jres.blocks))
        tres = make_generate_batched(tcfg, tcfg, EngineConfig(
            verifier=VerifierConfig(**v), max_new_tokens=ACC_NEW,
            temperature=1.0))(
                pd, pt, prompts.contiguous(), [ACC_PLEN] * runs,
                [torch.Generator().manual_seed(i) for i in range(runs)])
        out[("torch", K)] = _per_run_stats(tres.accepts.numpy(),
                                           tres.blocks.numpy())
    for K in (1, 11):
        (jm, jci), (tm, tci) = out[("jax", K)], out[("torch", K)]
        assert abs(jm - tm) < 1.5 * np.hypot(jci, tci), (K, out)
    jgain = out[("jax", 11)][0] - out[("jax", 1)][0]
    tgain = out[("torch", 11)][0] - out[("torch", 1)][0]
    ci = np.sqrt(sum(out[k][1] ** 2 for k in out))
    print({f"{p} K={K}": out[(p, K)] for p, K in out}, jgain, tgain)
    assert abs(jgain - tgain) < 1.5 * ci, (jgain, tgain, out)
