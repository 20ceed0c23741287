"""The port's continuous-batching SlotEngine (hsd_tpu_torch/engine/server.py)
on the CPU.

* The cases of tests/test_server.py, less the tensor- and pipeline-parallel
  parity ones (they wait for the port's parallel slice): more requests than
  slots, incremental admission, K = 2 parallel and striped slots with
  telemetry, many admissions, last-slot admission, a per-request budget
  freeing its slot early, and several pool blocks between admissions
  (steps_per_dispatch > 1) with budgets and completion. Where the port's
  scheduler differs (admissions are capped at admit_batch a step and refill
  stays on the host), the case says so.
* Against the JAX package: at temperature 0, every served request's stream
  equals the JAX SlotEngine's, token for token, on a bridged tiny dense
  pair (float32) at K = 1, K = 2 parallel and K = 2 striped, with
  heterogeneous budgets.
* Sampled: every served request equals make_generate on that request's
  generator (hsd, tokenwise, blockwise; K = 1, K = 2 parallel and
  striped); a seeded run repeats exactly. The pool's products see more rows
  than make_generate's; on the CPU the float32 roundings that may differ
  are ~1e-7, and the pinned seeds have no decision that near a tie.
* The pool: a slot frozen at its budget, its length at S - 2, keeps every
  ragged write inside the cache and its state untouched; the target
  override protocol (flattened rows, per-row lengths, `(init, put,
  select)`) gives the default's streams.
"""
import jax
import numpy as np
import pytest
import torch

from hsd_tpu.config import EngineConfig as JEng
from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.config import VerifierConfig as JVer
from hsd_tpu.engine.server import SlotEngine as JSlotEngine
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine import make_generate
from hsd_tpu_torch.engine.kvcache import put_rows, select_rows
from hsd_tpu_torch.engine.server import SlotEngine
from hsd_tpu_torch.engine.speculative import SlotPool
from hsd_tpu_torch.models import init_params, transformer

torch.set_num_threads(2)
CFG = ModelConfig.tiny(vocab_size=64)
PD = init_params(CFG, seed=0, device="cpu")
PT = init_params(CFG, seed=1, device="cpu")


def _eng_cfg(max_new=8, K=1, parallel=True, method="hsd", temperature=1.0,
             gamma=3):
    return EngineConfig(verifier=VerifierConfig(method=method, gamma=gamma,
                                                num_drafts=K,
                                                parallel=parallel),
                        max_new_tokens=max_new, temperature=temperature)


def _engine(n_slots=2, max_new=8, K=1, **kw):
    return SlotEngine(CFG, CFG, _eng_cfg(max_new, K), n_slots=n_slots,
                      bucket=16, params_d=PD, params_t=PT, device="cpu", **kw)


def test_more_requests_than_slots():
    eng = _engine(n_slots=2)
    for rid in range(5):
        eng.submit(rid, list(range(1, 9 + rid)))
    done = eng.run_all()
    assert sorted(r.rid for r in done) == [0, 1, 2, 3, 4]
    for r in done:
        assert 1 <= len(r.out_tokens) <= 8
        assert all(0 <= t < 64 for t in r.out_tokens)


def test_incremental_admission():
    eng = _engine(n_slots=2)
    eng.submit(0, list(range(1, 10)))
    out = []
    steps = 0
    while steps < 50 and (eng.queue or eng.running or steps == 0):
        out.extend(eng.step())
        steps += 1
        if steps == 2:
            eng.submit(1, list(range(3, 12)))      # admitted mid-flight
        if not eng.queue and not eng.running:
            break
    assert sorted(r.rid for r in out) == [0, 1]


def test_multidraft_slots():
    eng = _engine(n_slots=2, K=2)
    assert eng.R == 2 and not eng.striped
    eng.submit(0, list(range(1, 9)))
    eng.submit(1, list(range(2, 10)))
    done = eng.run_all()
    assert sorted(r.rid for r in done) == [0, 1]


def test_striped_slots_and_telemetry():
    """Striped multidraft slots (parallel=False) and the per-request
    accepts / blocks telemetry and aggregate stats()."""
    eng = SlotEngine(CFG, CFG, _eng_cfg(K=2, parallel=False), n_slots=2,
                     bucket=16, params_d=PD, params_t=PT, device="cpu")
    assert eng.striped and eng.R == 1 + 3 * (2 - 1)
    eng.submit(0, list(range(1, 9)))
    eng.submit(1, list(range(2, 10)))
    done = eng.run_all()
    assert sorted(r.rid for r in done) == [0, 1]
    for r in done:
        assert r.blocks >= 1
        assert 0 <= r.accepts <= r.blocks * 3
        # commits = accepts + one bonus per block (up to the EOS/budget cut)
        assert len(r.out_tokens) <= r.accepts + r.blocks
    st = eng.stats()
    assert st["blocks"] >= 2 and st["committed"] >= 2
    assert st["block_efficiency"] >= 1.0
    assert st["tokens_per_s"] > 0


def test_admissions_over_several_steps():
    """More pending requests than admit_batch: the port admits admit_batch
    a step (the JAX package fills every free slot, in scatters of
    admit_batch); occupancy is host state, and every request completes
    with its output region."""
    eng = SlotEngine(CFG, CFG, _eng_cfg(max_new=6), n_slots=4, bucket=16,
                     params_d=PD, params_t=PT, admit_batch=2, device="cpu")
    for rid in range(6):
        eng.submit(rid, list(range(1, 8 + rid)))
    eng._admit()
    assert sum(r >= 0 for r in eng.slot_rid) == 2 and len(eng.queue) == 4
    eng._admit()
    assert sum(r >= 0 for r in eng.slot_rid) == 4 and len(eng.queue) == 2
    done = eng.run_all()
    assert sorted(r.rid for r in done) == list(range(6))
    for r in done:
        assert 1 <= len(r.out_tokens) <= 6


def test_last_slot_admission():
    """tests/test_server.py's last-slot case: requests driven so that an
    admission lands alone in the last slot mid-flight; every request
    completes within a bounded step count (no slot left occupied and never
    live)."""
    eng = _engine(n_slots=4, max_new=8)
    rng = np.random.default_rng(0)
    for rid in range(9):
        n = int(rng.integers(6, 14))
        eng.submit(rid, rng.integers(1, 60, (n,)).tolist())
    done = []
    for i in range(200):
        done.extend(eng.step())
        if not eng.queue and not eng.running:
            break
    assert sorted(r.rid for r in done) == list(range(9)), eng.slot_rid
    assert i < 199, "run did not converge (slot deadlock)"


def test_per_request_budget_frees_slot_early():
    """A short-budget request stops at ITS budget on the device and its
    slot frees while the longer ones run on."""
    eng = _engine(n_slots=2, max_new=12)
    eng.submit(0, list(range(1, 9)), max_new=2)   # tiny budget
    eng.submit(1, list(range(2, 10)))             # the full 12
    eng.submit(2, list(range(3, 11)))             # queued: needs a slot
    done = {}
    for i in range(60):
        for r in eng.step():
            done[r.rid] = (i, r)
        if not eng.queue and not eng.running:
            break
    assert sorted(done) == [0, 1, 2]
    step0, r0 = done[0]
    step1, r1 = done[1]
    assert len(r0.out_tokens) <= 2
    assert r0.blocks <= 2, r0.blocks
    assert step0 < step1


def test_several_blocks_between_admissions():
    """steps_per_dispatch = 3: every request completes, the budgets hold,
    the telemetry adds up, and the block loop ends early when a slot frees
    while requests wait (the port keeps the refill on the host: the JAX
    macro step's on-device refill is not ported)."""
    eng = SlotEngine(CFG, CFG, _eng_cfg(max_new=8), n_slots=2, bucket=16,
                     params_d=PD, params_t=PT, steps_per_dispatch=3,
                     device="cpu")
    budgets = [8, 2, 5, 8, 3]
    for rid, mn in enumerate(budgets):
        eng.submit(rid, list(range(1, 9 + rid)), max_new=mn)
    blocks = []
    real = eng._pool_step

    def counted():
        blocks.append(len(eng.queue))
        return real()
    eng._pool_step = counted
    done = []
    steps = 0
    while eng.queue or eng.running:
        n0 = len(blocks)
        finished = eng.step()
        done.extend(finished)
        steps += 1
        ran = len(blocks) - n0
        assert 1 <= ran <= 3
        if ran < 3 and (eng.queue or eng.running):
            # ended early: a slot freed while requests waited
            assert finished and blocks[-1] > 0
    assert sorted(r.rid for r in done) == list(range(5))
    for r in done:
        assert 1 <= len(r.out_tokens) <= budgets[r.rid]
        assert r.blocks >= 1
    st = eng.stats()
    assert st["committed"] == sum(len(r.out_tokens) for r in done)
    assert st["blocks"] == sum(r.blocks for r in done)
    assert steps < len(blocks)            # several blocks a step


# ---------------------------------------------------------------------------
# against the JAX SlotEngine at temperature 0

JCFG = JCfg.tiny(vocab_size=64)
JPD = j_init_params(JCFG, jax.random.PRNGKey(0))
JPT = j_init_params(JCFG, jax.random.PRNGKey(1))
BUDGETS = [10, 3, 7, 10, 5]


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(1, 62, (int(rng.integers(5, 16)),)).tolist()
            for _ in BUDGETS]


@pytest.mark.parametrize("K,parallel,method", [(1, True, "greedy"),
                                               (2, True, "hsd"),
                                               (2, False, "hsd")])
def test_greedy_streams_equal_jax_server(K, parallel, method):
    """Bridged dense pair, temperature 0, heterogeneous budgets, more
    requests than slots: each served stream is the JAX SlotEngine's."""
    jeng = JEng(verifier=JVer(method=method, gamma=3, num_drafts=K,
                              parallel=parallel),
                max_new_tokens=10, temperature=0.0)
    js = JSlotEngine(JCFG, JCFG, jeng, n_slots=2, bucket=16, params_d=JPD,
                     params_t=JPT)
    ts = SlotEngine(CFG, CFG, _eng_cfg(10, K, parallel, method, 0.0),
                    n_slots=2, bucket=16,
                    params_d=bridge.params_from_jax(JPD),
                    params_t=bridge.params_from_jax(JPT),
                    steps_per_dispatch=2, device="cpu")
    for rid, (p, mn) in enumerate(zip(_prompts(), BUDGETS)):
        js.submit(rid, p, max_new=mn)
        ts.submit(rid, p, max_new=mn)
    want = {r.rid: r.out_tokens.tolist() for r in js.run_all()}
    got = {r.rid: r.out_tokens for r in ts.run_all()}
    assert sorted(got) == list(range(len(BUDGETS)))
    assert got == want
    assert any(len(v) == BUDGETS[k] for k, v in got.items())


# ---------------------------------------------------------------------------
# sampled: each request is make_generate on its own generator

@pytest.mark.parametrize("method,K,parallel", [
    ("hsd", 1, True), ("tokenwise", 1, True), ("blockwise", 1, True),
    ("hsd", 2, True), ("hsd", 2, False), ("tokenwise", 2, False)])
def test_sampled_request_equals_make_generate(method, K, parallel):
    eng = _eng_cfg(10, K, parallel, method)
    se = SlotEngine(CFG, CFG, eng, n_slots=2, bucket=16, params_d=PD,
                    params_t=PT, seed=5, steps_per_dispatch=2,
                    device="cpu")
    gens = {}
    for rid, (p, mn) in enumerate(zip(_prompts(), BUDGETS)):
        # the first two carry their own generator, the rest the engine's
        g = torch.Generator().manual_seed(100 + rid) if rid < 2 else None
        gens[rid] = (100 + rid) if rid < 2 else (5 << 32) + rid
        se.submit(rid, p, max_new=mn, generator=g)
    done = {r.rid: r for r in se.run_all()}
    gen = make_generate(CFG, CFG, eng)
    for rid, r in done.items():
        res = gen(PD, PT, torch.tensor(r.prompt), r.prompt_len,
                  torch.Generator().manual_seed(gens[rid]))
        want = res.tokens[16:res.length].tolist()[:BUDGETS[rid]]
        assert r.out_tokens == want, rid
        # its telemetry is make_generate's over the blocks it ran
        acc = res.accepts[:res.blocks].tolist()
        assert 1 <= r.blocks <= res.blocks
        assert r.accepts == sum(acc[:r.blocks])


def test_seeded_run_repeats():
    def run():
        se = _engine(n_slots=2, max_new=10, seed=3)
        for rid, (p, mn) in enumerate(zip(_prompts(), BUDGETS)):
            se.submit(rid, p, max_new=mn)
        return {r.rid: (r.out_tokens, r.accepts, r.blocks)
                for r in se.run_all()}
    a, b = run(), run()
    assert a == b and len(a) == len(BUDGETS)


# ---------------------------------------------------------------------------
# the pool

def test_frozen_slot_writes_stay_inside_the_cache():
    """A slot done at its budget with its length at S - 2 (the most a block
    can leave) stops being live; the next blocks compute its rows at an
    empty slot's frontier (else its target rows would write up to S +
    gamma - 3, out of range) and leave its tokens and length alone."""
    eng = _eng_cfg(max_new=8, gamma=4)
    P = 16
    S = P + 8 + 4 + 2
    pool = SlotPool(CFG, CFG, eng, 2, S, "cpu")
    prompt = (torch.arange(P) % 50) + 1
    for s in range(2):
        pool.prefill(s, PD, PT, prompt, P, 8)
    pool.length[0] = S - 2
    pool.live[0] = False
    frozen = pool.tokens[0].clone()
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        done, _ = pool.block(PD, PT, P, [False, True], [None, g])
        assert not bool(done[0])
    assert int(pool.length[0]) == S - 2
    assert torch.equal(pool.tokens[0], frozen)
    assert int(pool.length[1]) > P


def test_target_override_protocol():
    """A target override in the flattened-rows protocol with its own cache
    ops gives the default's streams; it sees per-row lengths in the pool
    block and None in the prefill."""
    seen = {"pool": 0, "prefill": 0}

    def tfwd(p, t, c, lengths, skip_head=False):
        seen["prefill" if lengths is None else "pool"] += 1
        return transformer.forward(CFG, p, t, c, lengths=lengths,
                                   skip_head=skip_head,
                                   slots=t.shape[0] // 2)

    def init(batch, max_len, start, device):
        from hsd_tpu_torch.engine.kvcache import init_cache
        return init_cache(CFG, batch, max_len, device).replace(start=start)

    outs = []
    for override in (False, True):
        kw = dict(target_forward=tfwd,
                  target_cache_ops=(init, put_rows, select_rows)
                  ) if override else {}
        se = SlotEngine(CFG, CFG, _eng_cfg(10, K=2), n_slots=2, bucket=16,
                        params_d=PD, params_t=PT, device="cpu", **kw)
        for rid, (p, mn) in enumerate(zip(_prompts(), BUDGETS)):
            se.submit(rid, p, max_new=mn)
        outs.append({r.rid: r.out_tokens for r in se.run_all()})
    assert outs[0] == outs[1]
    assert seen["prefill"] == len(BUDGETS) and seen["pool"] > 0
