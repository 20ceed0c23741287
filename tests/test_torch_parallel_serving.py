"""Continuous-batching serving over the port's sharded targets (the mesh
cases of tests/test_server.py and tests/test_eagle_server.py), on gloo
ranks on the CPU, f32.

* SlotEngine over `make_tp_server_forward` (tp 2) and over
  `make_pp_server_forward` (pp 2) == SlotEngine over the plain target in
  one process, token for token, under hsd sampling from one seed (the JAX
  file's pinned, tie-free seeds); every rank serves the same streams.
* EagleSlotEngine over `make_tp_eagle_pool_forward` (the staged tree
  append and the compaction on the kv-head shard) == the plain pool.
* Every case runs macro steps of 3 pool blocks with more requests than
  slots, so freed slots take staged requests inside a macro (the refill's
  merge through `tp_pool_cache_ops` / `pp_pool_cache_ops` on the shards):
  refilled_total > 0 on every rank and in the plain run, the same
  number.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parallel_ranks as R
from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.models import eagle as jeagle
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, VerifierConfig
from hsd_tpu_torch.engine.eagle_server import EagleSlotEngine
from hsd_tpu_torch.engine.server import SlotEngine
from hsd_tpu_torch.models import eagle as teagle
from hsd_tpu_torch.parallel import run_ranks
from test_torch_tp import tcfg

torch.set_num_threads(2)
DCFG = tcfg(JCfg.tiny(vocab_size=64))
ENG = EngineConfig(verifier=VerifierConfig(method="hsd", gamma=3),
                   max_new_tokens=6)
# (prompt, budget): more requests than the 2 slots, budgets apart
PROMPTS = [(list(range(1, 9)), 6), (list(range(2, 11)), 2),
           (list(range(5, 12)), 4), (list(range(3, 13)), 6),
           (list(range(7, 14)), 3)]
STEPS = 3


def _slot_case(jcfg, layout):
    """(the plain engine's streams in this process, the rank call)."""
    cfg_t = tcfg(jcfg)
    pt = bridge.params_from_jax(j_init_params(jcfg, jax.random.PRNGKey(1)))
    pd = bridge.params_from_jax(j_init_params(JCfg.tiny(vocab_size=64),
                                              jax.random.PRNGKey(0)))
    se = SlotEngine(DCFG, cfg_t, ENG, n_slots=2, bucket=16, params_d=pd,
                    params_t=pt, seed=7, device="cpu",
                    steps_per_dispatch=STEPS)
    for rid, (p, mn) in enumerate(PROMPTS):
        se.submit(rid, p, max_new=mn)
    base = ({r.rid: list(r.out_tokens) for r in se.run_all()},
            se.refilled_total)
    return base, ("tp_slot_engine", (DCFG, cfg_t, pd, pt, ENG, 2, 16,
                                     PROMPTS, 7, layout, STEPS))


def _eagle_case():
    jtcfg = JCfg.tiny(vocab_size=64, hidden_size=32, intermediate_size=64,
                      num_layers=2, num_heads=4, num_kv_heads=4,
                      tie_word_embeddings=False)
    jecfg = jeagle.EagleConfig(
        hidden_size=32, target_hidden_size=32, num_heads=4, num_kv_heads=2,
        vocab_size=64, draft_vocab_size=64, intermediate_size=64, top_k=4,
        depth=3, total_tokens=11, dtype=jnp.float32,
        rope_theta=jtcfg.rope_theta)
    cfg_t = tcfg(jtcfg)
    ecfg = teagle.EagleConfig(**{f.name: getattr(jecfg, f.name)
                                 for f in dataclasses.fields(jecfg)
                                 if f.name != "dtype"}, dtype=torch.float32)
    pt = bridge.params_from_jax(j_init_params(jtcfg, jax.random.PRNGKey(1)))
    pe = bridge.eagle_params_from_jax(
        jeagle.init_eagle_params(jecfg, jax.random.PRNGKey(2)))
    eng = EngineConfig(max_new_tokens=8, temperature=1.0)
    prompts = [(list(range(3 + i, 11 + i)), mn)
               for i, mn in enumerate((8, 3, 5, 8, 4))]
    se = EagleSlotEngine(cfg_t, ecfg, eng, n_slots=2, bucket=16, params_t=pt,
                         params_e=pe, mode="hsd", seed=5, device="cpu",
                         steps_per_dispatch=STEPS)
    for rid, (p, mn) in enumerate(prompts):
        se.submit(rid, p, max_new=mn)
    base = ({r.rid: list(r.out_tokens) for r in se.run_all()},
            se.refilled_total)
    return base, ("tp_eagle_server", (cfg_t, ecfg, pt, pe, eng, 2, 16,
                                      prompts, "hsd", 5, STEPS))


@pytest.fixture(scope="module")
def served():
    """The three cases' plain runs here and their sharded runs in one
    world of 2."""
    cases = [_slot_case(JCfg.tiny(vocab_size=64, num_kv_heads=4,
                                  tie_word_embeddings=False), "tp"),
             _slot_case(JCfg.tiny(vocab_size=64), "pp"), _eagle_case()]
    res = run_ranks(R.batch, 2, [c for _, c in cases], device="cpu")
    return [(base, [r[i] for r in res]) for i, (base, _) in enumerate(cases)]


def _same(case, n):
    (base, refilled), ranks = case
    assert sorted(base) == list(range(n))
    assert refilled > 0
    for out in ranks:
        assert out == (base, refilled), (out, base)


def test_server_tp_token_parity(served):
    _same(served[0], 5)


def test_server_pp_token_parity(served):
    _same(served[1], 5)


def test_eagle_server_batched_tp_token_parity(served):
    _same(served[2], 5)
