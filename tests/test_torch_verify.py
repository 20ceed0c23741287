"""Port parity of ops/sampling.py and the verifiers against the JAX package.

Each verifier gets the uniforms and Gumbel vectors that the JAX function
draws from its key (the fold_in schedule in hsd_tpu/verify/*.py), so the
port must reach IDENTICAL decisions: n_matches, draft_index, tokens and
rounds. Distributions are built with numpy from a seed. process_logits is
compared at atol 1e-6 (float32 softmax of the same logits).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.ops import sampling as jsamp
from hsd_tpu.verify import dispatch as jdisp
from hsd_tpu_torch.ops import sampling as tsamp
from hsd_tpu_torch.verify import verify as tverify

torch.set_num_threads(2)
GAMMA, V, CASES = 5, 12, 50


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, 0, 1.0), (1.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 5, 1.0),
    (1.0, 0, 0.8), (0.5, 7, 0.9)])
def test_process_logits(temperature, top_k, top_p):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((4, 3, 50)) * 3).astype(np.float32)
    want = np.asarray(jsamp.process_logits(jnp.asarray(logits), temperature,
                                           top_k, top_p))
    got = tsamp.process_logits(torch.from_numpy(logits), temperature, top_k,
                               top_p).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_sample_with_shared_gumbel():
    """sample = Gumbel-max with the 1e-38 clamp, as jax.random.categorical."""
    rng = np.random.default_rng(2)
    for i in range(20):
        probs = rng.dirichlet(np.full(30, 0.3), size=4).astype(np.float32)
        probs[:, :3] = 0.0
        key = jax.random.PRNGKey(i)
        want = np.asarray(jsamp.sample(key, jnp.asarray(probs)))
        g = np.asarray(jax.random.gumbel(key, probs.shape, jnp.float32))
        got = tsamp.sample(torch.from_numpy(probs),
                           noise=torch.from_numpy(g.copy())).numpy()
        np.testing.assert_array_equal(got, want)


def _jax_noise(method, key, K):
    """The uniforms / Gumbel vectors the JAX verifier draws from `key`."""
    f = jax.random.fold_in
    if method == "tokenwise":
        return {"u": jnp.stack([jax.random.uniform(f(key, 2 * b), (GAMMA,))
                                for b in range(K)]),
                "gumbel": jax.random.gumbel(f(key, 2 * K + 1), (V,))}
    if method in ("hsd", "hsd_ref"):
        return {"u": jnp.stack([jax.random.uniform(f(key, 3 * b), (GAMMA,))
                                for b in range(K)]),
                "u2": jnp.stack([jax.random.uniform(f(key, 3 * b + 1), ())
                                 for b in range(K)]),
                "gumbel": jax.random.gumbel(f(key, 3 * K + 2), (V,))}
    if method == "blockwise":
        return {"gumbel": jnp.stack([jax.random.gumbel(f(key, i), (V + 1,))
                                     for i in range(GAMMA)]),
                "u": jax.random.uniform(f(key, GAMMA + 1), ()),
                "gumbel_bonus": jax.random.gumbel(f(key, GAMMA + 2), (V,))}
    return None


def _problem(rng, K):
    """Random verification problem: drafts sampled from q, often sharing
    prefixes across rows; p is q perturbed (sometimes equal, sometimes
    one-hot) so every branch of the rules is reached."""
    sharp = rng.choice([0.3, 1.0, 3.0])
    q = rng.dirichlet(np.full(V, sharp), size=(K, GAMMA)).astype(np.float32)
    mode = rng.integers(0, 4)
    if mode == 0:
        p = np.concatenate([q, rng.dirichlet(np.full(V, sharp),
                                             size=(K, 1))], axis=1)
    else:
        p = rng.dirichlet(np.full(V, sharp), size=(K, GAMMA + 1))
        mix = rng.random()
        p[:, :GAMMA] = mix * p[:, :GAMMA] + (1 - mix) * q
        if mode == 3:
            hot = np.zeros_like(p)
            np.put_along_axis(hot, p.argmax(-1)[..., None], 1.0, axis=-1)
            p = hot
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    toks = np.zeros((K, GAMMA), np.int32)
    for b in range(K):
        for j in range(GAMMA):
            toks[b, j] = rng.choice(V, p=q[b, j] / q[b, j].sum())
    for b in range(1, K):       # share a prefix with row 0 half the time
        if rng.random() < 0.5:
            m = rng.integers(1, GAMMA + 1)
            toks[b, :m] = toks[0, :m]
    return toks, q, p


@functools.lru_cache(maxsize=None)
def _jax_fns(method, K):
    fn = jax.jit(functools.partial(jdisp.verify, method, num_drafts=K))
    nz = jax.jit(functools.partial(_jax_noise, method, K=K))
    return fn, nz


@pytest.mark.parametrize("method,K", [
    ("hsd", 1), ("hsd", 3), ("hsd_ref", 1), ("hsd_ref", 3),
    ("tokenwise", 1), ("tokenwise", 3), ("blockwise", 1), ("greedy", 1)])
def test_verifier_decisions_identical(method, K):
    fn, nz = _jax_fns(method, K)
    rng = np.random.default_rng(100 + 7 * K + len(method))
    for case in range(CASES):
        toks, q, p = _problem(rng, K)
        key = jax.random.PRNGKey(1000 + case)
        res = fn(key, jnp.asarray(toks), jnp.asarray(q), jnp.asarray(p))
        noise = nz(key)
        tnoise = (None if noise is None else
                  {k: torch.from_numpy(np.array(v)) for k, v in noise.items()})
        got = tverify(method, torch.from_numpy(toks).long(),
                      torch.from_numpy(q), torch.from_numpy(p), noise=tnoise,
                      num_drafts=K)
        ctx = f"{method} K={K} case {case}"
        assert int(got.n_matches) == int(res.n_matches), ctx
        assert int(got.draft_index) == int(res.draft_index), ctx
        assert int(got.rounds) == int(res.rounds), ctx
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(res.tokens), err_msg=ctx)


@pytest.mark.parametrize("method,K", [("hsd", 2), ("tokenwise", 2),
                                      ("blockwise", 1)])
def test_verifier_draws_from_generator(method, K):
    """Without a noise bundle the port draws from its generator: the same
    seed gives the same result, and results stay in range."""
    rng = np.random.default_rng(5)
    toks, q, p = _problem(rng, K)
    args = (torch.from_numpy(toks).long(), torch.from_numpy(q),
            torch.from_numpy(p))
    r1 = tverify(method, *args, generator=torch.Generator().manual_seed(3),
                 num_drafts=K)
    r2 = tverify(method, *args, generator=torch.Generator().manual_seed(3),
                 num_drafts=K)
    assert torch.equal(r1.tokens, r2.tokens)
    assert 0 <= int(r1.n_matches) <= GAMMA
    assert ((r1.tokens >= 0) & (r1.tokens < V)).all()
