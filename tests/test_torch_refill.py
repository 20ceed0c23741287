"""The on-device slot refill (the macro step with steps_per_dispatch M > 1)
of the port's SlotEngine and EagleSlotEngine against the JAX engines' on
the CPU: the schedule, not only the streams.

At temperature 0 on bridged tiny float32 pairs, M = 3, heterogeneous
budgets and more requests than slots (7 through 2 slots; the JAX files'
macro cases, tests/test_server.py:228-250 and tests/test_eagle_server.py:
103-134): the rid sets returned by successive step() calls are the JAX
engine's, so are refilled_total (> 0: freed slots took staged requests
inside a macro) and each request's tokens, blocks and accepts; EAGLE's
streams are also the target's greedy AR streams. And the refill's merge
leaves a slot in the state a direct admission gives it, over a slot that
held another request: every leaf of the slot's state, the draft side's
too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.config import EngineConfig as JEng
from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.config import VerifierConfig as JVer
from hsd_tpu.engine.eagle_server import EagleSlotEngine as JEagleSlotEngine
from hsd_tpu.engine.server import SlotEngine as JSlotEngine
from hsd_tpu.eval import synthetic as jsyn
from hsd_tpu.models import eagle as jeagle
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine import make_autoregressive
from hsd_tpu_torch.engine.eagle_server import EagleSlotEngine
from hsd_tpu_torch.engine.kvcache import merge_plan
from hsd_tpu_torch.engine.server import SlotEngine
from hsd_tpu_torch.eval.synthetic import make_coupled_eagle_target
from hsd_tpu_torch.models import eagle as teagle

torch.set_num_threads(2)
M = 3
BUDGETS = [10, 3, 7, 10, 5, 2, 8]


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(1, 62, (int(rng.integers(5, 16)),)).tolist()
            for _ in BUDGETS]


def _schedule(engine):
    """Run to the end one step() at a time: (the sorted rids each step
    returned, {rid: request})."""
    steps, done = [], {}
    while engine.queue or engine.running:
        out = engine.step()
        steps.append(sorted(r.rid for r in out))
        done.update({r.rid: r for r in out})
        assert len(steps) < 200
    return steps, done


def _same_run(jeng, teng):
    for rid, (p, mn) in enumerate(zip(_prompts(), BUDGETS)):
        jeng.submit(rid, p, max_new=mn)
        teng.submit(rid, p, max_new=mn)
    want_steps, want = _schedule(jeng)
    got_steps, got = _schedule(teng)
    assert sorted(got) == list(range(len(BUDGETS)))
    assert got_steps == want_steps
    assert teng.refilled_total == jeng.refilled_total > 0
    for rid, r in got.items():
        w = want[rid]
        assert r.out_tokens == np.asarray(w.out_tokens).tolist(), rid
        assert (r.blocks, r.accepts) == (w.blocks, w.accepts), rid
        assert 1 <= len(r.out_tokens) <= BUDGETS[rid]
    return got


@pytest.mark.parametrize("K,parallel,method", [(1, True, "greedy"),
                                               (2, False, "hsd")])
def test_slot_engine_schedule_equals_jax(K, parallel, method):
    """SlotEngine at K = 1 and K = 2 striped, temperature 0."""
    jcfg = JCfg.tiny(vocab_size=64)
    jpd = j_init_params(jcfg, jax.random.PRNGKey(0))
    jpt = j_init_params(jcfg, jax.random.PRNGKey(1))
    jeng = JSlotEngine(jcfg, jcfg, JEng(
        verifier=JVer(method=method, gamma=3, num_drafts=K,
                      parallel=parallel),
        max_new_tokens=10, temperature=0.0), n_slots=2, bucket=16,
        params_d=jpd, params_t=jpt, steps_per_dispatch=M)
    cfg = ModelConfig.tiny(vocab_size=64)
    teng = SlotEngine(cfg, cfg, EngineConfig(
        verifier=VerifierConfig(method=method, gamma=3, num_drafts=K,
                                parallel=parallel),
        max_new_tokens=10, temperature=0.0), n_slots=2, bucket=16,
        params_d=bridge.params_from_jax(jpd),
        params_t=bridge.params_from_jax(jpt), steps_per_dispatch=M,
        device="cpu")
    _same_run(jeng, teng)
    assert teng.stats()["host_reads"] <= teng.pool_blocks + len(
        BUDGETS) * 2


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


def test_eagle_schedule_equals_jax():
    """EagleSlotEngine in greedy mode over the coupled int8 pair of
    tests/test_torch_eagle_engine.py, and every stream the target's AR."""
    jhead, jtarget = jsyn.build_coupled_eagle_pair(
        jax.random.PRNGKey(0), JCFG, JECFG, scale=4.0, lam=1.0, big_bits=8)
    head = bridge.eagle_params_from_jax(jhead)
    target = bridge.coupled_eagle_from_jax(jtarget)
    jeng = JEagleSlotEngine(
        JCFG, JECFG, JEng(max_new_tokens=10, temperature=0.0), n_slots=2,
        bucket=16, params_t=jtarget, params_e=jhead, mode="greedy", seed=3,
        steps_per_dispatch=M,
        target_forward=jsyn.make_coupled_eagle_target(JCFG, (-1,)))
    fwd = make_coupled_eagle_target(CFG, (-1,))
    teng = EagleSlotEngine(
        CFG, ECFG, EngineConfig(max_new_tokens=10, temperature=0.0),
        n_slots=2, bucket=16, params_t=target, params_e=head, mode="greedy",
        seed=3, steps_per_dispatch=M, device="cpu", target_forward=fwd)
    got = _same_run(jeng, teng)
    ar = make_autoregressive(
        CFG, EngineConfig(max_new_tokens=12, temperature=0.0),
        model_forward=lambda p, t, c, skip_head=False: fwd(p, t, c, None,
                                                           None)[:2])
    for rid, r in got.items():
        prompt = _prompts()[rid]
        padded = torch.tensor([0] * (16 - len(prompt)) + prompt)
        toks, length = ar(target, padded, len(prompt), None)
        want = toks[16:length].tolist()
        n = min(len(r.out_tokens), len(want))
        assert n >= 1 and r.out_tokens[:n] == want[:n], rid


def _slot_state(eng):
    """Every leaf of slot 0's state (n_slots = 1): SlotPool's slot tensors
    and cache rows, or the EAGLE pool state's, the head KV and features
    included."""
    if isinstance(eng, SlotEngine):
        pool = eng.pool
        leaves = {k: getattr(pool, k) for k in (
            "tokens", "length", "max_new", "live", "acc_sum", "blk_cnt")}
        for name in ("dcache", "tcache"):
            c = getattr(pool, name)
            leaves.update({f"{name}.k": c.k, f"{name}.v": c.v,
                           f"{name}.start": c.start})
        return leaves
    st = eng.state
    leaves = {k: v for k, v in st.items() if torch.is_tensor(v)}
    leaves.update({f"tcache.{f}": getattr(st["tcache"], f)
                   for f in ("k", "v", "start")})
    leaves.update({f"ekv.{f}": t for f, t in zip(st["ekv"]._fields,
                                                    st["ekv"])})
    return leaves


def _pair_engines(kind):
    if kind == "slot":
        jcfg = JCfg.tiny(vocab_size=64)
        pd = bridge.params_from_jax(j_init_params(jcfg, jax.random.PRNGKey(0)))
        pt = bridge.params_from_jax(j_init_params(jcfg, jax.random.PRNGKey(1)))
        cfg = ModelConfig.tiny(vocab_size=64)
        eng = EngineConfig(verifier=VerifierConfig(method="hsd", gamma=3),
                           max_new_tokens=10)
        return [SlotEngine(cfg, cfg, eng, n_slots=1, bucket=16, params_d=pd,
                           params_t=pt, seed=2, steps_per_dispatch=2,
                           device="cpu") for _ in range(2)]
    jhead, jtarget = jsyn.build_coupled_eagle_pair(
        jax.random.PRNGKey(0), JCFG, JECFG, scale=4.0, lam=1.0, big_bits=8)
    head = bridge.eagle_params_from_jax(jhead)
    target = bridge.coupled_eagle_from_jax(jtarget)
    return [EagleSlotEngine(
        CFG, ECFG, EngineConfig(max_new_tokens=10, temperature=1.0),
        n_slots=1, bucket=16, params_t=target, params_e=head, mode="hsd",
        seed=2, steps_per_dispatch=2, device="cpu",
        target_forward=make_coupled_eagle_target(CFG, (-1,)))
        for _ in range(2)]


@pytest.mark.parametrize("kind", ["slot", "eagle"])
def test_merge_equals_admission(kind):
    """Slot 0 serves a first request for a macro of 2 blocks; then one
    engine admits a second request into it directly, the other stages it
    and merges it under the device mask. Every leaf of the slot's state is
    the same in both, so no state of the first request (draft cache, head
    KV, features, counters, budget) outlives the merge."""
    direct, merged = _pair_engines(kind)
    first, second = _prompts()[:2]
    for eng in (direct, merged):
        eng.submit(0, first, max_new=10)
        eng.submit(1, second, max_new=4)
        eng._admit()                      # the first request into slot 0
        assert eng.slot_rid == [0] and len(eng.queue) == 1
        eng._macro()                      # its blocks dirty the slot
        assert eng.slot_rid == [0] and eng.pool_blocks == 2
    req = direct.queue.popleft()
    direct.running[req.rid] = req
    direct._prefill_slot(0, req, direct._prompt(req))
    req = merged.queue.popleft()
    merged.running[req.rid] = req
    merged._stage_entry(0, req, merged._prompt(req))
    can, entry = torch.tensor([True]), torch.tensor([0])
    merged._merge(can, entry, merge_plan(can, entry, 1))
    want, got = _slot_state(direct), _slot_state(merged)
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name
