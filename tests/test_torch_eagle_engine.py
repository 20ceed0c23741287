"""End-to-end EAGLE decoding of the port on a tiny float32 coupled pair: a
symmetric-int8 target trunk (so the norm-fused int8 route, K5's plain
version, runs in every layer) coupled to the bigram oracle of a v1 head,
built by the JAX package and carried across by the bridge.

* make_eagle_generate at temperature 0 gives the JAX package's token
  stream, and the target's own greedy AR stream.
* EagleSlotEngine in greedy mode gives every request its AR stream, with
  one and with four pool blocks a step (the macro's refill); a
  single-request target_forward is refused at construction.
* One slot-batched pool block equals the single-slot block per slot.
* The prefill's last-position head equals the full forward's last row.
* The sampled modes (single request: typical, hsd, hsd_ref; server: hsd,
  typical) stay within budget and are reproducible from their seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.config import EngineConfig as JEng
from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.engine.eagle_engine import make_eagle_generate as j_generate
from hsd_tpu.eval import synthetic as jsyn
from hsd_tpu.models import eagle as jeagle
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, ModelConfig
from hsd_tpu_torch.engine import make_autoregressive
from hsd_tpu_torch.engine.eagle_engine import (make_eagle_block,
                                               make_eagle_generate,
                                               make_eagle_pool)
from hsd_tpu_torch.engine.eagle_server import EagleSlotEngine
from hsd_tpu_torch.engine.kvcache import KVCache, init_cache
from hsd_tpu_torch.eval.synthetic import make_coupled_eagle_target
from hsd_tpu_torch.models import eagle as teagle

torch.set_num_threads(2)
JCFG = JCfg.tiny(vocab_size=64, hidden_size=128, intermediate_size=256,
                 num_layers=2, num_heads=4, num_kv_heads=2,
                 tie_word_embeddings=False, attention_bias=False,
                 dtype=jnp.float32, eos_token_id=64)
JECFG = jeagle.EagleConfig(hidden_size=128, target_hidden_size=128,
                           num_heads=4, num_kv_heads=2, vocab_size=64,
                           draft_vocab_size=48, intermediate_size=256,
                           top_k=4, depth=3, total_tokens=11,
                           dtype=jnp.float32, rope_theta=JCFG.rope_theta,
                           version=1)
CFG = ModelConfig(**{f: getattr(JCFG, f) for f in (
    "vocab_size", "hidden_size", "intermediate_size", "num_layers",
    "num_heads", "num_kv_heads", "rope_theta", "rms_norm_eps",
    "tie_word_embeddings", "attention_bias", "eos_token_id")},
    dtype=torch.float32)
ECFG = teagle.EagleConfig(**{f.name: getattr(JECFG, f.name)
                             for f in dataclasses.fields(JECFG)
                             if f.name != "dtype"}, dtype=torch.float32)
PROMPT = (np.arange(10) % 50 + 3).astype(np.int32)
PLEN = 8


@pytest.fixture(scope="module")
def pair():
    jhead, jtarget = jsyn.build_coupled_eagle_pair(
        jax.random.PRNGKey(0), JCFG, JECFG, scale=4.0, lam=1.0, big_bits=8)
    return (jhead, jtarget, bridge.eagle_params_from_jax(jhead),
            bridge.coupled_eagle_from_jax(jtarget))


def _greedy(max_new):
    return EngineConfig(max_new_tokens=max_new, temperature=0.0)


def _ar_stream(target, prompt, plen, max_new):
    fwd = make_coupled_eagle_target(CFG, (-1,))
    ar = make_autoregressive(
        CFG, _greedy(max_new),
        model_forward=lambda p, t, c, skip_head=False: fwd(p, t, c, None,
                                                           None)[:2])
    toks, length = ar(target, torch.from_numpy(prompt).long(), plen, None)
    return toks[len(prompt):length].tolist()


def test_generate_greedy_equals_jax_and_ar(pair):
    jhead, jtarget, head, target = pair
    assert target.big.layers["wqkv"].zeros is None      # symmetric int8
    jres = j_generate(JCFG, JECFG, JEng(max_new_tokens=20, temperature=0.0),
                      mode="greedy",
                      target_forward=jsyn.make_coupled_eagle_target(
                          JCFG, (-1,)))(
        jtarget, jhead, jnp.asarray(PROMPT), jnp.int32(PLEN),
        jax.random.PRNGKey(1))
    gen = make_eagle_generate(CFG, ECFG, _greedy(20), mode="greedy",
                              target_forward=make_coupled_eagle_target(
                                  CFG, (-1,)))
    res = gen(target, head, torch.from_numpy(PROMPT).long(), PLEN, None)
    assert res.length == int(jres.length)
    assert res.blocks == int(jres.blocks)
    got = res.tokens[10:res.length].tolist()
    assert got == np.asarray(jres.tokens)[10:res.length].tolist()
    np.testing.assert_array_equal(res.accepts[:res.blocks].numpy(),
                                  np.asarray(jres.accepts)[:res.blocks])
    assert float(res.accepts[:res.blocks].float().mean()) > 0.5
    assert got == _ar_stream(target, PROMPT, PLEN, 20)[:len(got)]


def test_coupled_prefill_last_only(pair):
    """The coupled target's prefill with last_only gives the last row of
    the full forward's logits, and the same cache and features."""
    _, _, _, target = pair
    fwd = make_coupled_eagle_target(CFG, (-1,))
    toks = torch.from_numpy(PROMPT).long()[None]
    pos = torch.arange(toks.shape[1])[None]
    caches = [init_cache(CFG, 1, 16, "cpu") for _ in range(2)]
    full, c0, f0 = fwd(target, toks, caches[0], None, pos)
    last, c1, f1 = fwd(target, toks, caches[1], None, pos, last_only=True)
    assert last.shape == (1, 1, CFG.vocab_size)
    torch.testing.assert_close(last, full[:, -1:], rtol=1e-5, atol=1e-5)
    assert torch.equal(c0.k, c1.k) and torch.equal(f0, f1)


def _prompts():
    return [list(range(3 + i, 11 + i)) for i in range(6)]


@pytest.mark.parametrize("steps", [1, 4])
def test_server_greedy_matches_ar(pair, steps):
    _, _, head, target = pair
    se = EagleSlotEngine(CFG, ECFG, _greedy(10), n_slots=2, bucket=16,
                         params_t=target, params_e=head, mode="greedy",
                         seed=3, steps_per_dispatch=steps, device="cpu",
                         target_forward=make_coupled_eagle_target(CFG, (-1,)))
    budgets = [10, 4, 7, 10, 5, 10]
    for rid, (p, mn) in enumerate(zip(_prompts(), budgets)):
        se.submit(rid, p, max_new=mn)
    done = se.run_all()
    assert sorted(r.rid for r in done) == list(range(6))
    for r in done:
        prompt = _prompts()[r.rid]
        padded = np.asarray([0] * (16 - len(prompt)) + prompt, np.int32)
        want = _ar_stream(target, padded, len(prompt), 12)
        n = min(len(r.out_tokens), len(want), budgets[r.rid])
        assert n >= 1
        assert r.out_tokens[:n] == want[:n], r.rid
        assert len(r.out_tokens) <= budgets[r.rid]
    assert se.stats()["block_efficiency"] > 1.0


def test_server_guards(pair):
    """The JAX engine's signature guard: the pool needs a target_forward
    that takes lengths= and staging_at= (or **kwargs); a single-request
    one is refused at construction, not inside the first block."""
    _, _, head, target = pair
    kw = dict(n_slots=2, bucket=16, params_t=target, params_e=head,
              mode="greedy", device="cpu")
    with pytest.raises(ValueError, match="staging_at"):
        EagleSlotEngine(CFG, ECFG, _greedy(8),
                        target_forward=lambda p, t, c, ab, pos: None, **kw)
    EagleSlotEngine(CFG, ECFG, _greedy(8),
                    target_forward=lambda p, t, c, ab, pos, **k: None, **kw)


def test_pool_block_equals_single_slot_block(pair):
    """Two slots at different frontiers and left pads: each pool block
    (staged tree forward, per-row lengths, staged compaction) gives every
    slot the single-slot block's tokens and length."""
    _, _, head, target = pair
    fwd = make_coupled_eagle_target(CFG, (-1,))
    eng = _greedy(12)
    prefill, block, _, _ = make_eagle_block(CFG, ECFG, eng, mode="greedy",
                                            target_forward=fwd)
    pool_block = make_eagle_pool(CFG, ECFG, eng, mode="greedy",
                                 target_forward=fwd)
    prompts = [(np.arange(16) % 40 + 5).astype(np.int32),
               (np.arange(16) % 30 + 9).astype(np.int32)]
    single = [prefill(target, head, torch.from_numpy(p).long(), n, None)
              for p, n in zip(prompts, (16, 11))]
    N1 = ECFG.total_tokens + 1
    cat = lambda i: torch.cat([s[i] for s in single])
    tc = [s[2] for s in single]
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, N1))
    pool = KVCache(k=pad(torch.cat([c.k for c in tc], 1)),
                   v=pad(torch.cat([c.v for c in tc], 1)), length=0,
                   start=torch.cat([c.start for c in tc]))
    ekv = teagle.EagleKV(*(torch.cat([s[3][f] for s in single])
                           for f in range(4)))
    tokens, lengths, feat = cat(0), cat(1), cat(4)
    for _ in range(3):
        (tokens, lengths, _, _, _, pool, ekv, feat) = pool_block(
            target, head, tokens, lengths, pool, ekv, feat, None)
        for b, s in enumerate(single):
            out = block(target, head, *s, None)
            single[b] = (out[0], out[1], out[5], out[6], out[7])
            assert int(out[1][0]) == int(lengths[b])
            assert torch.equal(out[0][0], tokens[b])


@pytest.mark.parametrize("mode", ["typical", "hsd", "hsd_ref"])
def test_generate_sampled_smoke_and_seeded(pair, mode):
    """The single-request loop in each sampling mode: within budget, in
    range, accept lengths within the trie's depth, reproducible from the
    generator's seed."""
    _, _, head, target = pair
    gen = make_eagle_generate(CFG, ECFG,
                              EngineConfig(max_new_tokens=12, temperature=1.0),
                              mode=mode, target_forward=make_coupled_eagle_target(
                                  CFG, (-1,)))
    prompt = torch.from_numpy(PROMPT).long()
    res = gen(target, head, prompt, PLEN, torch.Generator().manual_seed(4))
    assert 1 <= res.ncommit <= 12
    toks = res.tokens[10:res.length]
    assert ((toks >= 0) & (toks < 64)).all()
    acc = res.accepts[:res.blocks]
    assert ((acc >= 0) & (acc <= ECFG.depth + 1)).all()
    again = gen(target, head, prompt, PLEN, torch.Generator().manual_seed(4))
    assert again.length == res.length and torch.equal(again.tokens, res.tokens)


@pytest.mark.parametrize("mode", ["hsd", "typical"])
def test_server_sampled_smoke_and_seeded(pair, mode):
    _, _, head, target = pair

    def run():
        se = EagleSlotEngine(CFG, ECFG,
                             EngineConfig(max_new_tokens=8, temperature=1.0),
                             n_slots=2, bucket=16, params_t=target,
                             params_e=head, mode=mode, seed=0, device="cpu",
                             steps_per_dispatch=2,
                             target_forward=make_coupled_eagle_target(
                                 CFG, (-1,)))
        for rid, p in enumerate(_prompts()[:4]):
            se.submit(rid, p, max_new=8)
        done = se.run_all()
        return {r.rid: r.out_tokens for r in done}, se.stats()

    out, st = run()
    assert sorted(out) == list(range(4))
    assert all(1 <= len(t) <= 8 for t in out.values())
    assert all(0 <= x < 64 for t in out.values() for x in t)
    assert st["block_efficiency"] >= 1.0
    assert st["committed"] == sum(len(t) for t in out.values())
    assert run()[0] == out
