"""The striped multidraft layout (VerifierConfig(parallel=False), K > 1) of
the port against the JAX package.

* Losslessness on the Markov harness (tests/torch_markov.py) within the
  JAX file's bands (tests/test_verify_exactness.py:124-137).
* The striped verifiers' decisions identical to JAX's `verify(...,
  striped=True)` under the JAX noise, on random R-row problems whose branch
  rows mirror row 0 up to their activation step.
* The striped `draft_rows` against JAX's `_draft_block_striped` on a
  bridged 2-layer f32 model, fed JAX's per-row Gumbel draws: tokens equal,
  q within 1e-5, and each mirrored row's cache entries bitwise row 0's up
  to its activation step.
* make_generate and make_stream_generate with the striped layout on a tiny
  pair.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.engine import kvcache as jkv
from hsd_tpu.engine import speculative as jspec
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu.models import transformer as jtf
from hsd_tpu.verify import dispatch as jdisp
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine import make_generate, make_stream_generate
from hsd_tpu_torch.engine.speculative import draft_rows
from hsd_tpu_torch.models import init_params
from hsd_tpu_torch.ops.sampling import processor
from hsd_tpu_torch.verify import verify as tverify
from test_torch_verify import GAMMA, V, _jax_noise, _problem
from torch_markov import TOL, run, tv_distance

torch.set_num_threads(2)
CASES = 200


@pytest.mark.parametrize("method,tol", [("tokenwise", TOL), ("hsd", TOL),
                                        ("hsd_ref", 0.20)])
def test_striped_tree_multidraft(method, tol):
    """The prefix gate (a branch row is valid exactly while the accepted
    prefix still follows the primary) makes the striped layout lossless
    for tokenwise and capped hsd; hsd_ref keeps the reference's ungated
    rows and its band."""
    emp, target, draft = run(method, 3, striped=True)
    d_target = tv_distance(emp, target)
    assert d_target < tol, f"striped {method}: TV {d_target:.4f}"
    assert tv_distance(emp, draft) > d_target + 0.05


def _striped_problem(rng, K):
    """A random striped problem: test_torch_verify._problem's R = 1 +
    GAMMA * (K - 1) rows (p is q perturbed, sometimes equal, sometimes
    one-hot), then the rows of group j (1 + j * (K - 1) + c) made row 0's
    in their tokens before position j and in q and p through position j;
    some branches also pick row 0's token at j."""
    R = 1 + GAMMA * (K - 1)
    toks, q, p = _problem(rng, R)
    for r in range(1, R):
        j = (r - 1) // (K - 1)
        toks[r] = np.where(np.arange(GAMMA) < j, toks[0], toks[r])
        q[r, :j + 1] = q[0, :j + 1]
        p[r, :j + 1] = p[0, :j + 1]
        if rng.random() < 0.3:
            toks[r, j] = toks[0, j]
    return toks, q, p


@functools.lru_cache(maxsize=None)
def _jax_fns(method, K):
    fn = jax.jit(functools.partial(jdisp.verify, method, num_drafts=K,
                                   striped=True))
    nz = jax.jit(functools.partial(_jax_noise, method, K=K))
    return fn, nz


@pytest.mark.parametrize("method,K", [
    ("tokenwise", 2), ("tokenwise", 3), ("hsd", 2), ("hsd", 3),
    ("hsd_ref", 2), ("hsd_ref", 3)])
def test_striped_decisions_identical(method, K):
    fn, nz = _jax_fns(method, K)
    rng = np.random.default_rng(300 + 7 * K + len(method))
    rows_seen = set()
    for case in range(CASES):
        toks, q, p = _striped_problem(rng, K)
        key = jax.random.PRNGKey(5000 + case)
        res = fn(key, jnp.asarray(toks), jnp.asarray(q), jnp.asarray(p))
        noise = {k: torch.from_numpy(np.array(v))
                 for k, v in nz(key).items()}
        got = tverify(method, torch.from_numpy(toks).long(),
                      torch.from_numpy(q), torch.from_numpy(p), noise=noise,
                      num_drafts=K, striped=True)
        ctx = f"{method} K={K} case {case}"
        assert int(got.n_matches) == int(res.n_matches), ctx
        assert int(got.draft_index) == int(res.draft_index), ctx
        assert int(got.rounds) == int(res.rounds), ctx
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(res.tokens), err_msg=ctx)
        rows_seen.add(int(res.draft_index))
    # the cases reach branch rows, not only the primary
    assert len(rows_seen) > K, rows_seen


def test_striped_telemetry_one_row_per_round():
    rng = np.random.default_rng(9)
    toks, q, p = _striped_problem(rng, 3)
    res, tel = tverify("hsd", torch.from_numpy(toks).long(),
                       torch.from_numpy(q), torch.from_numpy(p),
                       generator=torch.Generator().manual_seed(1),
                       num_drafts=3, striped=True, return_telemetry=True)
    assert tel.step_back_probs.shape == (3, GAMMA)
    ran = int(res.rounds)
    assert ran >= 1
    assert (tel.q_i[ran:] == 0).all()
    # round 0 always runs: q_i of a drafted token (1 past the window) > 0
    assert (tel.q_i[0] > 0).all()


def test_striped_layout_only_for_multidraft_verifiers():
    toks = torch.zeros((1, GAMMA), dtype=torch.int64)
    q = torch.full((1, GAMMA, V), 1.0 / V)
    p = torch.full((1, GAMMA + 1, V), 1.0 / V)
    with pytest.raises(ValueError):
        tverify("blockwise", toks, q, p, striped=True)


JCFG = JCfg.tiny(vocab_size=64)
TCFG = ModelConfig.tiny(vocab_size=64)


@pytest.mark.parametrize("K", [2, 3])
def test_draft_block_striped_matches_jax(K):
    """Same weights, same prompt, same per-row Gumbel draws: the port's
    striped drafter gives JAX's tokens and q; rows not yet active keep row
    0's tokens and KV bitwise."""
    gamma, P, plen = 4, 10, 8
    R = 1 + gamma * (K - 1)
    jp = j_init_params(JCFG, jax.random.PRNGKey(0))
    prompt = (np.arange(P) % 50 + 1).astype(np.int32)
    S = P + gamma + 4
    start = jnp.full((R,), P - plen, jnp.int32)
    jc = jkv.init_cache(JCFG, R, S)._replace(start=start)
    _, jc = jtf.forward(JCFG, jp, jnp.broadcast_to(prompt[None, :-2],
                                                   (R, P - 2)), jc)
    key = jax.random.PRNGKey(7)
    temp = 1.0
    jt, jq, jc2 = jspec._draft_block_striped(
        JCFG, jp, jc, jnp.int32(prompt[-2]), jnp.int32(prompt[-1]), key,
        gamma, K, temp)
    # the draws JAX's drafter makes: split(key, gamma)[j], then per row
    noise = torch.from_numpy(np.stack([np.stack([
        np.asarray(jax.random.gumbel(rk, (JCFG.vocab_size,), jnp.float32))
        for rk in jax.random.split(kj, R)])
        for kj in jax.random.split(key, gamma)]))

    tp = bridge.params_from_jax(jp)
    tc = bridge.cache_from_jax(jc)
    pt = torch.from_numpy(prompt).long()
    tt, tq, tc2 = draft_rows(TCFG, tp, tc, pt[-2], pt[-1], gamma, K, True,
                             processor(temp), None, noise=lambda j: noise[j])
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5,
                               rtol=0)
    L = P - 2          # positions the block wrote: L .. L + gamma
    assert tc2.length == int(jc2.length) == L + gamma + 1
    act = [0] + [j for j in range(gamma) for _ in range(K - 1)]
    for r in range(1, R):
        same = L + 2 + act[r]   # positions fed row 0's tokens
        assert (tt[r, :act[r]] == tt[0, :act[r]]).all()
        for buf in (tc2.k, tc2.v):
            assert torch.equal(buf[:, r, :same], buf[:, 0, :same]), r


PD = init_params(TCFG, seed=0, device="cpu")
PT = init_params(TCFG, seed=1, device="cpu")
PROMPT = (torch.arange(10) % 50) + 1
PLEN = 7


def _striped_engine(method, K=3, gamma=4, max_new=24, temp=1.0):
    return EngineConfig(verifier=VerifierConfig(method=method, gamma=gamma,
                                                num_drafts=K, parallel=False),
                        max_new_tokens=max_new, temperature=temp)


@pytest.mark.parametrize("method,K", [("tokenwise", 2), ("tokenwise", 3),
                                      ("hsd", 2), ("hsd", 3),
                                      ("hsd_ref", 3)])
def test_striped_generate(method, K):
    eng = _striped_engine(method, K, max_new=16)
    gen = make_generate(TCFG, TCFG, eng)
    r1 = gen(PD, PT, PROMPT, PLEN, torch.Generator().manual_seed(11))
    r2 = gen(PD, PT, PROMPT, PLEN, torch.Generator().manual_seed(11))
    assert 1 <= r1.ncommit <= 16
    toks = r1.tokens[10:r1.length]
    assert ((toks >= 0) & (toks < TCFG.vocab_size)).all()
    acc = r1.accepts[:r1.blocks]
    assert ((acc >= 0) & (acc <= 4)).all()
    assert r1.length == r2.length and torch.equal(r1.tokens, r2.tokens)


@pytest.mark.parametrize("method", ["tokenwise", "hsd"])
def test_striped_same_model_full_acceptance(method):
    res = make_generate(TCFG, TCFG, _striped_engine(method))(
        PT, PT, PROMPT, PLEN, torch.Generator().manual_seed(5))
    acc = res.accepts[:res.blocks].float()
    assert res.blocks >= 1
    assert float(acc.mean()) >= 3.8, acc


def test_striped_greedy_temperature_matches_ar():
    """Temperature 0 makes every row the argmax chain: the striped stream
    is the greedy AR stream."""
    from hsd_tpu_torch.engine import make_autoregressive
    res = make_generate(TCFG, TCFG, _striped_engine("hsd", temp=0.0))(
        PD, PT, PROMPT, PLEN, torch.Generator().manual_seed(3))
    toks, length = make_autoregressive(
        TCFG, EngineConfig(max_new_tokens=24, temperature=0.0))(
            PT, PROMPT, PLEN, None)
    n = min(res.length, length)
    assert n > 10
    np.testing.assert_array_equal(res.tokens[10:n].numpy(),
                                  toks[10:n].numpy())


@pytest.mark.parametrize("method", ["hsd", "tokenwise"])
def test_striped_stream_equals_generate(method):
    eng = _striped_engine(method, max_new=20)
    chunks = list(make_stream_generate(TCFG, TCFG, eng)(
        PD, PT, PROMPT, PLEN, torch.Generator().manual_seed(9)))
    res = make_generate(TCFG, TCFG, eng)(
        PD, PT, PROMPT, PLEN, torch.Generator().manual_seed(9))
    stream = [t for c in chunks for t in c.tolist()]
    assert stream == res.tokens[10:res.length].tolist()
    assert len(chunks) == res.blocks
