"""Port parity of the stepwise / recursive engines, their verification
steps and the verifiers' telemetry against the JAX package.

* `forward_sampling_step` and `recursive_round` reach IDENTICAL decisions
  on 240 random problems each, given the uniforms and Gumbel vectors the
  JAX functions draw from their keys; recursive_round's residual rows
  agree within 1e-4 relative (they scale with r = exp(log Jp - log Jq),
  whose float32 cumulative sums may differ by an ulp between XLA and
  torch, and exp amplifies that).
* Telemetry of tokenwise, hsd and hsd_ref equals the JAX package's within
  1e-4, per verifier call and over a make_generate(collect_telemetry=True)
  run. HSD's step-back probabilities are 1 - s_plus / denom with s_plus a
  sum of r * p - q over the vocabulary, which cancels where r * p is near
  q, so the ulps in which XLA's and torch's float32 log, exp and
  cumulative sums differ grow there (measured up to 1.1e-5); a later
  round's p_i is read from the previous round's normalized residual.
* Greedy streams of make_stepwise_generate and make_recursive_generate
  equal the JAX engines' (tokens, blocks, accepts, draft lengths, rounds),
  with attention by the einsum path and under each K8 mode; a pair with
  head_dim 64 and a cache of at least 128 slots, so the modes reach the
  kernel. In the port, both equal greedy AR.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsd_tpu.ops.flash_decode as jfd
from hsd_tpu.config import EngineConfig as JEng
from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.config import VerifierConfig as JVer
from hsd_tpu.engine import make_generate as j_make_generate
from hsd_tpu.engine.stepwise import make_recursive_generate as j_recursive
from hsd_tpu.engine.stepwise import make_stepwise_generate as j_stepwise
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu.verify import dispatch as jdisp
from hsd_tpu.verify.forward_sampling import forward_sampling_step as j_fs
from hsd_tpu.verify.recursive import recursive_round as j_rr
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine import (make_autoregressive, make_generate,
                                  make_recursive_generate,
                                  make_stepwise_generate)
from hsd_tpu_torch.ops import flash_decode as tfd
from hsd_tpu_torch.verify import (forward_sampling_step, recursive_round,
                                  verify)

torch.set_num_threads(2)
GAMMA, V, CASES = 5, 12, 240
F = jax.random.fold_in
# head_dim 256 / 4 = 64
JCFG = JCfg.tiny(vocab_size=64, hidden_size=256, intermediate_size=256,
                 num_layers=2, num_heads=4, num_kv_heads=2)
MODES = {None: None, "fused": ("FUSED_ATTN", "always"),
         "flash": ("FLASH_DECODE", "always")}


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _dists(rng, rows):
    """Rows of random distributions, some with exact zeros."""
    sharp = rng.choice([0.3, 1.0, 3.0])
    d = rng.dirichlet(np.full(V, sharp), size=rows)
    if rng.random() < 0.3:
        d[:, rng.integers(0, V, 3)] = 0.0
        d[d.sum(-1) == 0, 0] = 1.0
    return (d / d.sum(-1, keepdims=True)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _j_fs(last_step):
    def run(key, cand, q, p, n):
        out = j_fs(key, cand, q, p, n, last_step=last_step)
        noise = {"gumbel": jax.random.gumbel(F(key, 0), (V,)),
                 "gumbel_bonus": jax.random.gumbel(F(key, 1), (V,))}
        return out, noise
    return jax.jit(run)


def test_forward_sampling_decisions_identical():
    rng = np.random.default_rng(11)
    for case in range(CASES):
        q = _dists(rng, GAMMA)
        p = _dists(rng, GAMMA + 1)
        if rng.random() < 0.3:
            p[:GAMMA] = q
        cand = np.array([rng.choice(V, p=row) for row in q], np.int32)
        n = int(rng.integers(1, GAMMA + 1))
        last_step = bool(rng.random() < 0.5)
        key = jax.random.PRNGKey(case)
        (jt, jn), noise = _j_fs(last_step)(key, jnp.asarray(cand),
                                           jnp.asarray(q), jnp.asarray(p),
                                           jnp.int32(n))
        tt, tn = forward_sampling_step(
            _t(cand).long(), _t(q), _t(p), n, last_step=last_step,
            noise={k: _t(v) for k, v in noise.items()})
        ctx = f"case {case}"
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), ctx)
        assert int(tn) == int(jn), ctx


@jax.jit
def _j_rr(key, cand, q, p, hist, n):
    out = j_rr(key, cand, q, p, hist, n)
    noise = {"u": jax.random.uniform(F(key, 0), (GAMMA,)),
             "u2": jax.random.uniform(F(key, 1), ()),
             "gumbel": jax.random.gumbel(F(key, 2), (V,))}
    return out, noise


def test_recursive_round_decisions_identical():
    rng = np.random.default_rng(12)
    for case in range(CASES):
        hist = int(rng.integers(0, GAMMA))
        n = int(rng.integers(hist + 1, GAMMA + 1))
        q = _dists(rng, GAMMA)
        p = _dists(rng, GAMMA + 1)
        mix = rng.random()
        p[:GAMMA] = mix * p[:GAMMA] + (1 - mix) * q
        for j in range(hist):              # history rows: residual-like
            row = np.maximum(rng.normal(size=V), 0) * (rng.random(V) > 0.5)
            row[rng.integers(V)] += 0.3
            p[j] = row / row.sum()
        cand = np.array([rng.choice(V, p=row) for row in q], np.int32)
        key = jax.random.PRNGKey(1000 + case)
        (jo, jn, jf, jr), noise = _j_rr(key, jnp.asarray(cand),
                                        jnp.asarray(q), jnp.asarray(p),
                                        jnp.int32(hist), jnp.int32(n))
        to, tn, tf, tr = recursive_round(
            _t(cand).long(), _t(q), _t(p), hist, n,
            noise={k: _t(v) for k, v in noise.items()})
        ctx = f"case {case}"
        assert int(tn) == int(jn) and bool(tf) == bool(jf), ctx
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo), ctx)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5,
                                   rtol=1e-4, err_msg=ctx)


def _jax_noise(method, key, K):
    if method == "tokenwise":
        return {"u": jnp.stack([jax.random.uniform(F(key, 2 * b), (GAMMA,))
                                for b in range(K)]),
                "gumbel": jax.random.gumbel(F(key, 2 * K + 1), (V,))}
    return {"u": jnp.stack([jax.random.uniform(F(key, 3 * b), (GAMMA,))
                            for b in range(K)]),
            "u2": jnp.stack([jax.random.uniform(F(key, 3 * b + 1), ())
                             for b in range(K)]),
            "gumbel": jax.random.gumbel(F(key, 3 * K + 2), (V,))}


@pytest.mark.parametrize("method,K", [("tokenwise", 1), ("tokenwise", 3),
                                      ("hsd", 1), ("hsd", 3),
                                      ("hsd_ref", 2)])
def test_verifier_telemetry_matches_jax(method, K):
    fn = jax.jit(functools.partial(jdisp.verify, method, num_drafts=K,
                                   return_telemetry=True))
    nz = jax.jit(functools.partial(_jax_noise, method, K=K))
    rng = np.random.default_rng(13 + K + len(method))
    for case in range(40):
        q = np.stack([_dists(rng, GAMMA) for _ in range(K)])
        p = np.stack([_dists(rng, GAMMA + 1) for _ in range(K)])
        mix = rng.random()
        p[:, :GAMMA] = mix * p[:, :GAMMA] + (1 - mix) * q
        toks = np.array([[rng.choice(V, p=row) for row in qk] for qk in q],
                        np.int32)
        for b in range(1, K):
            if rng.random() < 0.5:
                toks[b, :2] = toks[0, :2]
        key = jax.random.PRNGKey(case)
        jres, jtel = fn(key, jnp.asarray(toks), jnp.asarray(q),
                        jnp.asarray(p))
        tres, ttel = verify(method, _t(toks).long(), _t(q), _t(p),
                            noise={k: _t(v) for k, v in nz(key).items()},
                            num_drafts=K, return_telemetry=True)
        ctx = f"{method} K={K} case {case}"
        assert int(tres.n_matches) == int(jres.n_matches), ctx
        for got, want in zip(ttel, jtel):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=0, err_msg=ctx)


def _tcfg(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "rms_norm_eps", "tie_word_embeddings",
        "attention_bias", "eos_token_id")}, dtype=torch.float32)


@pytest.fixture(scope="module")
def dense_pair():
    jd = j_init_params(JCFG, jax.random.PRNGKey(2))
    jt = j_init_params(JCFG, jax.random.PRNGKey(3))
    return jd, jt, bridge.params_from_jax(jd), bridge.params_from_jax(jt)


PROMPT = (np.arange(128) % 41 + 5).astype(np.int32)
PLEN = 121


def _engines(method, max_new=20, gamma=4):
    return (JEng(verifier=JVer(method=method, gamma=gamma),
                 max_new_tokens=max_new, temperature=0.0),
            EngineConfig(verifier=VerifierConfig(method=method, gamma=gamma),
                         max_new_tokens=max_new, temperature=0.0))


def test_generate_telemetry_matches_jax(dense_pair):
    jd, jt, td, tt = dense_pair
    jeng, teng = _engines("tokenwise")
    jres = j_make_generate(JCFG, JCFG, jeng, collect_telemetry=True)(
        jd, jt, jnp.asarray(PROMPT), jnp.int32(PLEN), jax.random.PRNGKey(0))
    tcfg = _tcfg(JCFG)
    tres = make_generate(tcfg, tcfg, teng, collect_telemetry=True)(
        td, tt, _t(PROMPT).long(), PLEN, None)
    assert tres.blocks == int(jres.blocks) > 1
    for name in ("step_back_probs", "p_i", "q_i"):
        np.testing.assert_allclose(getattr(tres, name).numpy(),
                                   np.asarray(getattr(jres, name)),
                                   atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("engine", ["stepwise", "recursive"])
def test_greedy_stream_matches_jax(monkeypatch, dense_pair, engine, mode):
    if mode is not None:
        attr, value = MODES[mode]
        monkeypatch.setattr(jfd, attr, value)
        monkeypatch.setattr(tfd, attr, value)
    jd, jt, td, tt = dense_pair
    jeng, teng = _engines("hsd_ref")
    jmake, tmake = {"stepwise": (j_stepwise, make_stepwise_generate),
                    "recursive": (j_recursive, make_recursive_generate)}[engine]
    jres = jmake(JCFG, JCFG, jeng)(jd, jt, jnp.asarray(PROMPT),
                                   jnp.int32(PLEN), jax.random.PRNGKey(0))
    tcfg = _tcfg(JCFG)
    tres = tmake(tcfg, tcfg, teng)(td, tt, _t(PROMPT).long(), PLEN, None)
    n = int(jres.length)
    assert tres.length == n and tres.blocks == int(jres.blocks) > 1
    np.testing.assert_array_equal(tres.tokens[:n].numpy(),
                                  np.asarray(jres.tokens)[:n])
    b = tres.blocks
    for name in ("accepts", "draft_lens", "rounds"):
        np.testing.assert_array_equal(getattr(tres, name)[:b].numpy(),
                                      np.asarray(getattr(jres, name))[:b],
                                      err_msg=name)
    # greedy speculative decoding is greedy AR
    toks, length = make_autoregressive(tcfg, teng)(tt, _t(PROMPT).long(),
                                                   PLEN, None)
    assert length == n
    np.testing.assert_array_equal(tres.tokens[:n].numpy(), toks[:n].numpy())


@pytest.mark.parametrize("engine", ["stepwise", "recursive"])
def test_sampled_engines_respect_budget(engine):
    cfg = ModelConfig.tiny(vocab_size=32, hidden_size=32,
                           intermediate_size=64)
    from hsd_tpu_torch.models import init_params
    pd, pt = init_params(cfg, 0, "cpu"), init_params(cfg, 1, "cpu")
    eng = EngineConfig(verifier=VerifierConfig(method="hsd_ref", gamma=3),
                       max_new_tokens=14, temperature=1.0, top_k=5)
    make = (make_stepwise_generate if engine == "stepwise"
            else make_recursive_generate)
    prompt = (torch.arange(8) % 20) + 1
    for seed in range(4):
        res = make(cfg, cfg, eng)(pd, pt, prompt, 8,
                                  torch.Generator().manual_seed(seed))
        assert 1 <= res.ncommit <= 14
        toks = res.tokens[8:res.length]
        assert ((toks >= 0) & (toks < 32)).all()
        acc, dl = res.accepts[:res.blocks], res.draft_lens[:res.blocks]
        assert ((acc >= 0) & (acc <= dl)).all() and (dl >= 3).all()
        assert (res.rounds[:res.blocks] >= 0).all()
