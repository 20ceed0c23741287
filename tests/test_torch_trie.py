"""Port parity of EAGLE trie drafting and trie verification against the JAX
package on the CPU, and the bridge's EAGLE structures.

* The three trie verifiers (greedy, typical, trie-HSD with both frontiers)
  on 200 random tree-shaped problems each, handed the uniforms the JAX
  functions draw from their keys: identical best rows and accept lengths,
  sampling distributions within 1e-6 (float32 sums over the vocabulary in
  another order). The (probs, retrieve_indices) layout and the
  materialized path rows give the same results, as tests/test_eagle.py:209
  checks for the JAX package.
* build_trie on a bridged v1 head: identical tokens, parents, masks,
  depths and retrieve indices, the head KV within 1e-5.
* The bridge carries EagleParams (bf16), CoupledEagleParams, EagleKV and
  Trie across bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.eval import synthetic as jsyn
from hsd_tpu.models import eagle as jeagle
from hsd_tpu.verify import trie as jtrie
from hsd_tpu_torch import bridge
from hsd_tpu_torch.models import eagle as teagle
from hsd_tpu_torch.verify import trie as ttrie

torch.set_num_threads(2)
N, DEPTH, V = 11, 3, 16
R, L = N + 1, DEPTH + 2
PROBLEMS, BATCH = 200, 50


def _problem(rng):
    """A random trie of N nodes under the root: each node hangs off an
    earlier node within the depth limit, siblings carry distinct tokens.
    Returns (candidates [R, L], probs [N+1, V], retrieve_indices [R, L])
    with the leaf paths sorted as build_trie sorts them."""
    parent, depth = [-1], [0]
    toks = [int(rng.integers(V))]
    kids = {0: set()}
    for i in range(1, N + 1):
        while True:
            p = int(rng.integers(i))
            if depth[p] <= DEPTH and len(kids[p]) < V - 1:
                break
        t = int(rng.choice([x for x in range(V) if x not in kids[p]]))
        kids[p].add(t)
        kids[i] = set()
        parent.append(p)
        depth.append(depth[p] + 1)
        toks.append(t)
    leaves = [i for i in range(N + 1) if not kids[i]]
    paths = []
    for leaf in leaves:
        path, c = [], leaf
        while c >= 0:
            path.append(c)
            c = parent[c]
        paths.append(path[::-1] + [-1] * (L - len(path)))
    paths.sort(key=lambda p: [x if x >= 0 else N + 5 for x in p])
    ri = np.full((R, L), -1, np.int32)
    ri[:len(paths)] = paths
    cand = np.where(ri >= 0, np.asarray(toks)[np.clip(ri, 0, N)], -1)
    # target rows: mass near the drafted children so paths get accepted
    probs = rng.dirichlet(np.full(V, rng.choice([0.2, 1.0])), size=N + 1)
    for i in range(N + 1):
        for t in kids[i]:
            probs[i, t] += rng.choice([0.0, 0.5, 3.0])
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    return cand.astype(np.int32), probs, ri


def _noise(kind, key):
    f = jax.random.fold_in
    if kind == "typical":
        return {"u": jnp.stack([
            jnp.stack([jax.random.uniform(f(key, i * R + j)) for j in range(R)])
            for i in range(1, L)])}
    return {"u": jnp.stack([jax.random.uniform(f(key, 2 * b), (L,))
                            for b in range(R)]),
            "u2": jnp.stack([jax.random.uniform(f(key, 2 * b + 1))
                             for b in range(R)])}


JAX_FNS = {
    "greedy": lambda k, c, p: jtrie.verify_trie_greedy(c, p),
    "typical": jtrie.verify_trie_typical,
    "hsd": jtrie.verify_trie_hsd,
    "hsd_raw": lambda k, c, p: jtrie.verify_trie_hsd(k, c, p, frontier="raw"),
}


def _port(kind, cand, p, noise):
    if kind == "greedy":
        return ttrie.verify_trie_greedy(cand, p)
    if kind == "typical":
        return ttrie.verify_trie_typical(cand, p, noise=noise)
    return ttrie.verify_trie_hsd(cand, p, noise=noise,
                                 frontier="raw" if kind == "hsd_raw"
                                 else "capped")


@pytest.mark.parametrize("kind", ["greedy", "typical", "hsd", "hsd_raw"])
def test_trie_verifier_decisions_identical(kind):
    rng = np.random.default_rng({"greedy": 1, "typical": 2, "hsd": 3,
                                 "hsd_raw": 4}[kind])
    jfn = jax.jit(jax.vmap(lambda k, c, pr, ri: JAX_FNS[kind](k, c, (pr, ri))))
    jnz = jax.jit(jax.vmap(lambda k: _noise(kind, k)))
    accepted = 0
    for chunk in range(PROBLEMS // BATCH):
        probs = [_problem(rng) for _ in range(BATCH)]
        cand = np.stack([p[0] for p in probs])
        pr = np.stack([p[1] for p in probs])
        ri = np.stack([p[2] for p in probs])
        keys = jax.random.split(jax.random.PRNGKey(chunk), BATCH)
        jb, ja, js = jfn(keys, jnp.asarray(cand), jnp.asarray(pr),
                         jnp.asarray(ri))
        noise = (None if kind == "greedy" else
                 {k: torch.from_numpy(np.array(v))
                  for k, v in jnz(keys).items()})
        tc = torch.from_numpy(cand).long()
        tp = (torch.from_numpy(pr), torch.from_numpy(ri).long())
        tb, ta, ts = _port(kind, tc, tp, noise)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb), err_msg=kind)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja), err_msg=kind)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6,
                                   err_msg=kind)
        accepted += int((ta > 0).sum())
        # the materialized path rows give the same results bit for bit
        rows = tp[0][torch.arange(BATCH)[:, None, None],
                     torch.clamp(tp[1], 0, N)]
        mb, ma, ms = _port(kind, tc, rows, noise)
        assert torch.equal(mb, tb) and torch.equal(ma, ta)
        assert torch.equal(ms, ts)
    assert accepted > PROBLEMS // 4, accepted    # the rules were exercised


ECFG = jeagle.EagleConfig(hidden_size=32, target_hidden_size=32, num_heads=4,
                          num_kv_heads=2, vocab_size=64, draft_vocab_size=48,
                          intermediate_size=64, top_k=4, depth=3,
                          total_tokens=11, dtype=jnp.float32,
                          rope_theta=10000.0, version=1)


def _tecfg(jc):
    return teagle.EagleConfig(**{f.name: getattr(jc, f.name)
                                 for f in dataclasses.fields(jc)
                                 if f.name != "dtype"}, dtype=torch.float32)


def test_build_trie_identical():
    """Two rows with different prefixes, frontiers and left pads, against
    one JAX call each, then a second trie on the returned KV."""
    jp = jeagle.init_eagle_params_v1(ECFG, jax.random.PRNGKey(1))
    jp = jp._replace(d2t=jnp.arange(48, dtype=jnp.int32) % 3)
    tp = bridge.eagle_params_from_jax(jp)
    tcfg = _tecfg(ECFG)
    rng = np.random.default_rng(7)
    T = 6
    feats = rng.standard_normal((2, T, 32)).astype(np.float32)
    toks = rng.integers(0, 64, size=(2, T)).astype(np.int32)
    prefix = np.array([0, 5], np.int32)
    start = np.array([0, 2], np.int32)
    roots = np.array([7, 30], np.int32)
    jkvs = [jeagle.init_eagle_kv(ECFG, 1, 64)._replace(
        start=jnp.int32(start[b])) for b in range(2)]
    tkv = teagle.init_eagle_kv(tcfg, 2, 64, "cpu")._replace(
        start=torch.from_numpy(start).long())
    for step in range(2):
        want = [jeagle.build_trie(ECFG, jp, jnp.asarray(feats[b:b + 1]),
                                  jnp.asarray(toks[b:b + 1]),
                                  jkvs[b]._replace(length=jnp.int32(prefix[b])),
                                  jnp.int32(prefix[b]), jnp.int32(roots[b]))
                for b in range(2)]
        trie, tkv = teagle.build_trie(
            tcfg, tp, torch.from_numpy(feats), torch.from_numpy(toks).long(),
            tkv._replace(length=torch.from_numpy(prefix).long()),
            torch.from_numpy(prefix).long(), torch.from_numpy(roots).long())
        for b, (jt, jkv) in enumerate(want):
            for f in teagle.Trie._fields:
                np.testing.assert_array_equal(
                    getattr(trie, f)[b].numpy(), np.asarray(getattr(jt, f)),
                    err_msg=f"step {step} row {b} {f}")
            assert int(tkv.length[b]) == int(jkv.length)
            n = int(jkv.length)
            np.testing.assert_allclose(tkv.k[b, :n].numpy(),
                                       np.asarray(jkv.k)[0, :n], atol=1e-5)
            jkvs[b] = jkv
        assert int(trie.num_paths.min()) >= 2
        prefix = prefix + T
        feats = rng.standard_normal((2, T, 32)).astype(np.float32)
        toks = rng.integers(0, 64, size=(2, T)).astype(np.int32)


def test_bridge_eagle_roundtrip():
    ecfg = dataclasses.replace(ECFG, dtype=jnp.bfloat16)
    from hsd_tpu.config import ModelConfig as JCfg
    jcb = JCfg.tiny(vocab_size=64, hidden_size=32, intermediate_size=64,
                    tie_word_embeddings=False, dtype=jnp.float32)
    head, cp = jsyn.build_coupled_eagle_pair(jax.random.PRNGKey(0), jcb, ecfg,
                                             scale=3.0, lam=0.5, big_bits=8)
    th = bridge.eagle_params_from_jax(head)
    assert th.embed.dtype == torch.bfloat16 and th.d2t.dtype == torch.int64
    for f in jeagle.EagleParams._fields:
        a, b = getattr(head, f), getattr(th, f)
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a).astype(np.float32), f)
    tcp = bridge.coupled_eagle_from_jax(cp)
    assert (tcp.scale, tcp.lam) == (3.0, 0.5)
    np.testing.assert_array_equal(tcp.lm_head.float().numpy(),
                                  np.asarray(cp.lm_head).astype(np.float32))
    wqkv = tcp.big.layers["wqkv"]
    assert wqkv.zeros is None and wqkv.qweight.dtype == torch.int8
    np.testing.assert_array_equal(wqkv.qweight.numpy(),
                                  np.asarray(cp.big.layers["wqkv"].qweight))
    jkv = jeagle.init_eagle_kv(ECFG, 1, 16)._replace(
        k=jax.random.normal(jax.random.PRNGKey(2), (1, 16, 2, 8)),
        length=jnp.int32(5), start=jnp.int32(1))
    tkv = bridge.eagle_kv_from_jax(jkv)
    assert tkv.length.tolist() == [5] and tkv.start.tolist() == [1]
    np.testing.assert_array_equal(tkv.k[0].numpy(), np.asarray(jkv.k)[0])
    jp = jeagle.init_eagle_params_v1(ECFG, jax.random.PRNGKey(3))
    jt, _ = jeagle.build_trie(ECFG, jp, jnp.ones((1, 4, 32)),
                              jnp.arange(4, dtype=jnp.int32)[None],
                              jeagle.init_eagle_kv(ECFG, 1, 64), jnp.int32(0),
                              jnp.int32(3))
    tt = bridge.trie_from_jax(jt)
    assert tt.tree_mask.dtype == torch.bool
    for f in teagle.Trie._fields:
        np.testing.assert_array_equal(getattr(tt, f)[0].numpy(),
                                      np.asarray(getattr(jt, f)), f)
