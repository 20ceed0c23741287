"""The engines over the port's tensor-parallel target (the engine cases of
tests/test_tp_pallas.py): gloo ranks on the CPU, the kernels' plain
versions on each rank's Megatron shard, f32.

* Greedy speculative decoding with the TP target == the JAX package's
  single-device greedy AR chain, token for token (and the port's TP AR).
* hsd sampling through the TP target repeats from its seed, and every
  rank commits the same tokens.
* K = 4 parallel multidraft: the row select composes with the kv-head
  shard; tokens in range, ranks equal.
* EAGLE trie decoding over the TP base (tree-masked forward, the feature
  stream replicated, compaction on the local shard) == JAX's greedy AR.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from hsd_tpu.config import EngineConfig as JEng
from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.engine import make_autoregressive as j_make_ar
from hsd_tpu.models import eagle as jeagle
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, VerifierConfig
from hsd_tpu_torch.models import eagle as teagle
from hsd_tpu_torch.parallel import run_ranks
from test_torch_tp import CFG, JCFG, quantize_params, tcfg

torch.set_num_threads(2)
PROMPT = np.asarray((np.arange(8) % 400) + 1, np.int32)


def _pair(seed_t, seed_d):
    pt = quantize_params(j_init_params(JCFG, jax.random.PRNGKey(seed_t)))
    dcfg = JCfg.tiny(vocab_size=512)
    pd = j_init_params(dcfg, jax.random.PRNGKey(seed_d))
    return pt, tcfg(dcfg), bridge.params_from_jax(pd)


def _j_ar(jcfg, jp, n=8):
    toks, length = j_make_ar(jcfg, JEng(max_new_tokens=n, temperature=0.0))(
        jp, jnp.asarray(PROMPT), jnp.int32(8), jax.random.PRNGKey(6))
    return np.asarray(toks), int(length)


def _eagle_cfgs():
    jtcfg = dataclasses.replace(
        JCfg.tiny(vocab_size=512, num_heads=8, num_kv_heads=4,
                  hidden_size=512, intermediate_size=512, num_layers=4),
        tie_word_embeddings=False, attention_bias=False)
    jecfg = jeagle.EagleConfig(
        hidden_size=64, target_hidden_size=512, num_heads=4, num_kv_heads=2,
        vocab_size=512, draft_vocab_size=512, intermediate_size=64, top_k=4,
        depth=3, total_tokens=11, dtype=jnp.float32, rope_theta=10000.0)
    return jtcfg, jecfg


@pytest.fixture(scope="module")
def runs():
    """Every case's rank work in one world of 2 (one spawn), with the JAX
    parameters each case's reference needs."""
    prompt = torch.from_numpy(PROMPT).long()
    greedy = EngineConfig(verifier=VerifierConfig(method="greedy", gamma=3),
                          max_new_tokens=8, temperature=0.0)
    hsd = EngineConfig(verifier=VerifierConfig(method="hsd", gamma=3),
                       max_new_tokens=8)
    multi = EngineConfig(verifier=VerifierConfig(method="hsd", gamma=3,
                                                 num_drafts=4),
                         max_new_tokens=8)
    jg, dcfg, pd = _pair(3, 4)
    jh, _, pdh = _pair(7, 8)
    jm, _, pdm = _pair(10, 11)
    jtcfg, jecfg = _eagle_cfgs()
    jet = j_init_params(jtcfg, jax.random.PRNGKey(0))
    pe = jeagle.init_eagle_params(jecfg, jax.random.PRNGKey(1))
    ecfg = teagle.EagleConfig(**{f.name: getattr(jecfg, f.name)
                                 for f in dataclasses.fields(jecfg)
                                 if f.name != "dtype"}, dtype=torch.float32)
    pg = bridge.params_from_jax(jg)
    calls = [
        ("tp_generate", (dcfg, CFG, pd, pg, greedy, prompt, 8, 5)),
        ("tp_autoregressive", (CFG, pg, greedy, prompt, 8)),
        ("tp_generate", (dcfg, CFG, pdh, bridge.params_from_jax(jh), hsd,
                         prompt, 8, 9, 2)),
        ("tp_generate", (dcfg, CFG, pdm, bridge.params_from_jax(jm), multi,
                         prompt, 8, 12)),
        ("tp_eagle_generate", (tcfg(jtcfg), ecfg, bridge.params_from_jax(jet),
                               bridge.eagle_params_from_jax(pe),
                               EngineConfig(max_new_tokens=8,
                                            temperature=0.0),
                               prompt, 8, "greedy", 5)),
    ]
    res = run_ranks(R.batch, 2, calls, device="cpu")
    return dict(ranks=res, jax=dict(greedy=jg, eagle=(jtcfg, jet)))


def test_tp_speculative_generate_greedy_equals_ar(runs):
    j_toks, j_len = _j_ar(JCFG, runs["jax"]["greedy"])
    (toks, length, _), = runs["ranks"][0][0]
    n = min(length, j_len)
    assert n > 8
    np.testing.assert_array_equal(toks[8:n].numpy(), j_toks[8:n])
    for r in runs["ranks"][1:]:
        (t, l, _), = r[0]
        assert l == length and torch.equal(t, toks)
    for r in runs["ranks"]:
        t, l = r[1]
        n = min(l, length)
        np.testing.assert_array_equal(t[8:n].numpy(), toks[8:n].numpy())


def test_tp_speculative_generate_hsd_deterministic(runs):
    (t1, l1, n1), (t2, l2, _) = runs["ranks"][0][2]
    assert n1 >= 1 and l1 == l2 and torch.equal(t1, t2)
    for r in runs["ranks"][1:]:   # every rank commits the same tokens
        assert all(torch.equal(a[0], b[0]) and a[1] == b[1]
                   for a, b in zip(r[2], runs["ranks"][0][2]))


def test_tp_speculative_multidraft(runs):
    (toks, length, ncommit), = runs["ranks"][0][3]
    assert ncommit >= 1
    new = toks[8:8 + ncommit]
    assert ((new >= 0) & (new < 512)).all()
    (t1, l1, _), = runs["ranks"][1][3]
    assert l1 == length and torch.equal(t1, toks)


def test_tp_eagle_greedy_equals_ar(runs):
    jtcfg, jet = runs["jax"]["eagle"]
    j_toks, j_len = _j_ar(jtcfg, jet)
    toks, length = runs["ranks"][0][4]
    n = min(length, j_len)
    assert n > 8
    np.testing.assert_array_equal(toks[8:n].numpy(), j_toks[8:n])
    t1, l1 = runs["ranks"][1][4]
    assert l1 == length and torch.equal(t1, toks)
