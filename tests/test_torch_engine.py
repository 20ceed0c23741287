"""End-to-end engine tests of the port on tiny float32 models.

* The greedy make_generate stream of the port equals the JAX package's on a
  bridged 2-layer coupled pair (int8 draft, int4 target + dense trunk) and
  on a bridged dense pair.
* Inside the port: greedy spec == greedy AR for any draft; a draft that is
  the target accepts every token; left padding is invisible; budgets and
  EOS truncation hold for every method.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.config import EngineConfig as JEng
from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.config import VerifierConfig as JVer
from hsd_tpu.engine import make_autoregressive as j_make_ar
from hsd_tpu.engine import make_generate as j_make_generate
from hsd_tpu.eval import synthetic as jsyn
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine import make_autoregressive, make_generate
from hsd_tpu_torch.eval.synthetic import CoupledParams, make_coupled_target
from hsd_tpu_torch.models import init_params

torch.set_num_threads(2)
CFG = ModelConfig.tiny(vocab_size=64)
PD = init_params(CFG, seed=0, device="cpu")
PT = init_params(CFG, seed=1, device="cpu")
PROMPT = (torch.arange(10) % 50) + 1
PLEN = 7


def _tcfg(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "rms_norm_eps", "tie_word_embeddings",
        "attention_bias", "eos_token_id")}, dtype=torch.float32)


def _spec(method, K, temp, max_new=24, gamma=4):
    eng = EngineConfig(verifier=VerifierConfig(method=method, gamma=gamma,
                                               num_drafts=K),
                       max_new_tokens=max_new, temperature=temp)
    return make_generate(CFG, CFG, eng)


def _greedy_engines(gamma=4, max_new=24):
    return (JEng(verifier=JVer(method="greedy", gamma=gamma),
                 max_new_tokens=max_new, temperature=0.0),
            EngineConfig(verifier=VerifierConfig(method="greedy", gamma=gamma),
                         max_new_tokens=max_new, temperature=0.0))


def test_greedy_stream_equals_jax_coupled_pair():
    """Bridged coupled pair: the port's greedy stream is the JAX stream."""
    jcs = JCfg.tiny(vocab_size=128, hidden_size=128, intermediate_size=256)
    jcb = JCfg.tiny(vocab_size=128, hidden_size=256, intermediate_size=512,
                    tie_word_embeddings=False)
    jd, jt = jsyn.build_coupled_pair(jax.random.PRNGKey(0), jcs, jcb,
                                     lam=0.5, logit_scale=1.5)
    jeng, teng = _greedy_engines()
    jfwd, jops = jsyn.make_coupled_target(jcs, jcb)
    jgen = j_make_generate(jcs, jcb, jeng, target_forward=jfwd,
                           target_cache_ops=jops)
    prompt = (np.arange(10) % 100 + 3).astype(np.int32)
    jres = jgen(jd, jt, jnp.asarray(prompt), jnp.int32(PLEN),
                jax.random.PRNGKey(1))

    tcs, tcb = _tcfg(jcs), _tcfg(jcb)
    tfwd, tops = make_coupled_target(tcs, tcb)
    td = bridge.params_from_jax(jd)
    tt = CoupledParams(big=bridge.params_from_jax(jt.big),
                       small=bridge.params_from_jax(jt.small),
                       lam=float(jt.lam))
    tres = make_generate(tcs, tcb, teng, target_forward=tfwd,
                         target_cache_ops=tops)(
        td, tt, torch.from_numpy(prompt).long(), PLEN, None)
    assert tres.length == int(jres.length)
    np.testing.assert_array_equal(tres.tokens[10:tres.length].numpy(),
                                  np.asarray(jres.tokens)[10:tres.length])
    assert tres.blocks == int(jres.blocks)

    # the AR baseline of the same coupled target agrees too
    jtok, jlen = j_make_ar(jcb, jeng, model_forward=jfwd,
                           cache_init=jops[0])(jt, jnp.asarray(prompt),
                                               jnp.int32(PLEN),
                                               jax.random.PRNGKey(2))
    ttok, tlen = make_autoregressive(tcb, teng, model_forward=tfwd,
                                     cache_init=tops[0])(
        tt, torch.from_numpy(prompt).long(), PLEN, None)
    assert tlen == int(jlen)
    np.testing.assert_array_equal(ttok[10:tlen].numpy(),
                                  np.asarray(jtok)[10:tlen])


def test_greedy_stream_equals_jax_dense_pair():
    jcfg = JCfg.tiny(vocab_size=64)
    jd = j_init_params(jcfg, jax.random.PRNGKey(0))
    jt = j_init_params(jcfg, jax.random.PRNGKey(1))
    jeng, teng = _greedy_engines(max_new=20)
    prompt = (np.arange(10) % 50 + 1).astype(np.int32)
    jres = j_make_generate(jcfg, jcfg, jeng)(
        jd, jt, jnp.asarray(prompt), jnp.int32(PLEN), jax.random.PRNGKey(2))
    tcfg = _tcfg(jcfg)
    tres = make_generate(tcfg, tcfg, teng)(
        bridge.params_from_jax(jd), bridge.params_from_jax(jt),
        torch.from_numpy(prompt).long(), PLEN, None)
    assert tres.length == int(jres.length)
    np.testing.assert_array_equal(tres.tokens[10:tres.length].numpy(),
                                  np.asarray(jres.tokens)[10:tres.length])


def test_greedy_spec_equals_greedy_ar():
    res = _spec("greedy", 1, 0.0)(PD, PT, PROMPT, PLEN, None)
    toks, length = make_autoregressive(
        CFG, EngineConfig(max_new_tokens=24, temperature=0.0))(
            PT, PROMPT, PLEN, None)
    n = min(res.length, length)
    assert n > 10
    np.testing.assert_array_equal(res.tokens[10:n].numpy(),
                                  toks[10:n].numpy())


@pytest.mark.parametrize("method,K", [("tokenwise", 1), ("hsd", 1),
                                      ("hsd", 3)])
def test_same_model_full_acceptance(method, K):
    res = _spec(method, K, 1.0)(PT, PT, PROMPT, PLEN,
                                torch.Generator().manual_seed(5))
    acc = res.accepts[:res.blocks].float()
    assert res.blocks >= 1
    assert float(acc.mean()) >= 3.8, acc


@pytest.mark.parametrize("method,K", [("tokenwise", 1), ("tokenwise", 2),
                                      ("hsd", 1), ("hsd", 2), ("hsd_ref", 2),
                                      ("blockwise", 1)])
def test_spec_generates_and_respects_budget(method, K):
    res = _spec(method, K, 1.0, max_new=16)(PD, PT, PROMPT, PLEN,
                                            torch.Generator().manual_seed(7))
    assert 1 <= res.ncommit <= 16
    toks = res.tokens[10:res.length]
    assert ((toks >= 0) & (toks < CFG.vocab_size)).all()
    acc = res.accepts[:res.blocks]
    assert ((acc >= 0) & (acc <= 4)).all()
    eos = (toks == CFG.eos_token_id).nonzero()
    assert eos.numel() == 0 or int(eos[0]) == toks.numel() - 1


def test_left_padding_invariance():
    gen = _spec("greedy", 1, 0.0, max_new=12)
    r1 = gen(PD, PT, PROMPT, PLEN, None)
    bigger = torch.cat([torch.zeros(6, dtype=torch.int64), PROMPT])
    r2 = gen(PD, PT, bigger, PLEN, None)
    np.testing.assert_array_equal(r1.tokens[10:22].numpy(),
                                  r2.tokens[16:28].numpy())


def test_seeded_generate_is_deterministic():
    gen = _spec("hsd", 2, 1.0, max_new=12)
    r1 = gen(PD, PT, PROMPT, PLEN, torch.Generator().manual_seed(42))
    r2 = gen(PD, PT, PROMPT, PLEN, torch.Generator().manual_seed(42))
    assert r1.length == r2.length
    assert torch.equal(r1.tokens, r2.tokens)
