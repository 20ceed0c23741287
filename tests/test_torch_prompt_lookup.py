"""Port parity of prompt-lookup drafting and streaming generation against the
JAX package.

* `propose_ngram` returns the JAX function's draft and n_found on random
  token arrays (small vocabularies, so n-grams repeat), for n-gram orders
  1-3 and gamma 3-5.
* Greedy prompt-lookup streams equal the JAX engine's (tokens, accepts,
  blocks), with attention by the einsum path and under each K8 mode
  (head_dim 64, a cache of at least 128 slots); in the port they equal
  greedy AR.
* Streaming: the greedy chunks equal the JAX generator's, and with the
  same generator seed at temperature 1 the chunks concatenate to
  make_generate's stream.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsd_tpu.ops.flash_decode as jfd
from hsd_tpu.config import EngineConfig as JEng
from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.config import VerifierConfig as JVer
from hsd_tpu.engine.prompt_lookup import make_prompt_lookup_generate as j_pl
from hsd_tpu.engine.prompt_lookup import propose_ngram as j_propose
from hsd_tpu.engine.streaming import make_stream_generate as j_stream
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine import (make_autoregressive, make_generate,
                                  make_prompt_lookup_generate,
                                  make_stream_generate, propose_ngram)
from hsd_tpu_torch.ops import flash_decode as tfd

torch.set_num_threads(2)
JCFG = JCfg.tiny(vocab_size=64, hidden_size=256, intermediate_size=256,
                 num_layers=2, num_heads=4, num_kv_heads=2)
MODES = {None: None, "fused": ("FUSED_ATTN", "always"),
         "flash": ("FLASH_DECODE", "always")}
# a prompt of repeated phrases, so the lookup proposes
PROMPT = np.array(([5, 9, 11, 7, 3, 9, 11] * 19)[:128], np.int32)
PLEN = 120


def _tcfg(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "rms_norm_eps", "tie_word_embeddings",
        "attention_bias", "eos_token_id")}, dtype=torch.float32)


@pytest.mark.parametrize("max_ngram,gamma", [(1, 3), (2, 4), (3, 5)])
def test_propose_ngram_matches_jax(max_ngram, gamma):
    rng = np.random.default_rng(max_ngram * 10 + gamma)
    jfn = jax.jit(j_propose, static_argnames=("gamma", "max_ngram"))
    found = 0
    for case in range(120):
        S = int(rng.integers(4, 30))
        toks = rng.integers(0, int(rng.integers(2, 6)), S).astype(np.int32)
        length = int(rng.integers(1, S + 1))
        jd, jn = jfn(jnp.asarray(toks), jnp.int32(length), gamma=gamma,
                     max_ngram=max_ngram)
        td, tn = propose_ngram(toks.tolist(), length, gamma, max_ngram)
        ctx = f"case {case}: {toks.tolist()} length {length}"
        assert tn == int(jn), ctx
        assert td == np.asarray(jd).tolist(), ctx
        found += tn > 0
    assert found > 40


@pytest.fixture(scope="module")
def target():
    jt = j_init_params(JCFG, jax.random.PRNGKey(4))
    return jt, bridge.params_from_jax(jt)


@pytest.mark.parametrize("mode", list(MODES))
def test_prompt_lookup_greedy_matches_jax(monkeypatch, target, mode):
    if mode is not None:
        attr, value = MODES[mode]
        monkeypatch.setattr(jfd, attr, value)
        monkeypatch.setattr(tfd, attr, value)
    jt, tt = target
    jeng = JEng(verifier=JVer(method="tokenwise", gamma=4),
                max_new_tokens=20, temperature=0.0)
    teng = EngineConfig(verifier=VerifierConfig(method="tokenwise", gamma=4),
                        max_new_tokens=20, temperature=0.0)
    jtok, jlen, jacc, jblocks = j_pl(JCFG, jeng)(
        jt, jnp.asarray(PROMPT), jnp.int32(PLEN), jax.random.PRNGKey(0))
    tcfg = _tcfg(JCFG)
    prompt = torch.from_numpy(PROMPT).long()
    ttok, tlen, tacc, tblocks = make_prompt_lookup_generate(tcfg, teng)(
        tt, prompt, PLEN, None)
    n = int(jlen)
    assert tlen == n and tblocks == int(jblocks)
    np.testing.assert_array_equal(ttok[:n].numpy(), np.asarray(jtok)[:n])
    np.testing.assert_array_equal(tacc[:tblocks].numpy(),
                                  np.asarray(jacc)[:tblocks])
    toks, length = make_autoregressive(tcfg, teng)(tt, prompt, PLEN, None)
    assert length == n
    np.testing.assert_array_equal(ttok[:n].numpy(), toks[:n].numpy())


@pytest.fixture(scope="module")
def pair():
    jd = j_init_params(JCFG, jax.random.PRNGKey(5))
    jt = j_init_params(JCFG, jax.random.PRNGKey(6))
    return jd, jt, bridge.params_from_jax(jd), bridge.params_from_jax(jt)


@pytest.mark.parametrize("K", [1, 2])
def test_stream_greedy_matches_jax(pair, K):
    jd, jt, td, tt = pair
    jeng = JEng(verifier=JVer(method="greedy", gamma=3, num_drafts=K),
                max_new_tokens=18, temperature=0.0)
    teng = EngineConfig(verifier=VerifierConfig(method="greedy", gamma=3,
                                                num_drafts=K),
                        max_new_tokens=18, temperature=0.0)
    jchunks = [c.tolist() for c in j_stream(JCFG, JCFG, jeng)(
        jd, jt, jnp.asarray(PROMPT), jnp.int32(PLEN), jax.random.PRNGKey(0))]
    tcfg = _tcfg(JCFG)
    tchunks = [c.tolist() for c in make_stream_generate(tcfg, tcfg, teng)(
        td, tt, torch.from_numpy(PROMPT).long(), PLEN, None)]
    assert tchunks == jchunks and len(tchunks) > 2


def test_stream_concatenates_to_generate(pair):
    """Same seed, temperature 1: the chunks are make_generate's stream."""
    _, _, td, tt = pair
    tcfg = _tcfg(JCFG)
    eng = EngineConfig(verifier=VerifierConfig(method="hsd", gamma=4),
                       max_new_tokens=24, temperature=1.0)
    prompt = torch.from_numpy(PROMPT).long()
    for seed in (1, 2):
        chunks = list(make_stream_generate(tcfg, tcfg, eng)(
            td, tt, prompt, PLEN, torch.Generator().manual_seed(seed)))
        res = make_generate(tcfg, tcfg, eng)(
            td, tt, prompt, PLEN, torch.Generator().manual_seed(seed))
        assert all(c.dtype == np.int64 for c in chunks)
        assert (np.concatenate(chunks).tolist()
                == res.tokens[128:res.length].tolist())
        assert len(chunks) == res.blocks
