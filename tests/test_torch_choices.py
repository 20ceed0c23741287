"""Port parity of static choice-tree drafting (models/choices.py) against
the JAX package on the CPU, at tiny float32 sizes.

* build_tree_buffers: every array and level table equal, for the shipped
  mc_sim_7b_63 tree and a small hand-made one; an orphan choice raises.
* build_static_trie on a bridged v3 head: two rows at different prefixes
  and left pads, each equal to one JAX call (tokens and every buffer
  identical, the head KV within 1e-5).
* Greedy make_eagle_generate with static_tree: the JAX stream and the
  target's greedy AR stream.
* The typical and trie-HSD verifiers on the static tree's paths, handed
  the uniforms the JAX functions draw from their keys: identical best rows
  and accept lengths, sampling distributions within 1e-6.
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
from hsd_tpu.models import choices as jch
from hsd_tpu.models import eagle as jeagle
from hsd_tpu.models import transformer as jtr
from hsd_tpu.verify import trie as jtrie
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, ModelConfig
from hsd_tpu_torch.engine import make_autoregressive
from hsd_tpu_torch.engine.eagle_engine import make_eagle_generate
from hsd_tpu_torch.models import choices as tch
from hsd_tpu_torch.models import eagle as teagle
from hsd_tpu_torch.verify import trie as ttrie

torch.set_num_threads(2)
JCFG = JCfg.tiny(vocab_size=64, hidden_size=32, intermediate_size=64,
                 num_layers=4, num_heads=4, num_kv_heads=2,
                 dtype=jnp.float32)
JTREE = jch.build_tree_buffers(jch.mc_sim_7b_63)
TREE = tch.build_tree_buffers(tch.mc_sim_7b_63)
JECFG = jch.eagle_config_for_tree(
    jeagle.EagleConfig(hidden_size=32, target_hidden_size=32, num_heads=4,
                       num_kv_heads=2, vocab_size=64, draft_vocab_size=64,
                       intermediate_size=64, dtype=jnp.float32,
                       rope_theta=10000.0), JTREE)
CFG = ModelConfig(**{f: getattr(JCFG, f) for f in (
    "vocab_size", "hidden_size", "intermediate_size", "num_layers",
    "num_heads", "num_kv_heads", "rope_theta", "rms_norm_eps",
    "tie_word_embeddings", "attention_bias", "eos_token_id")},
    dtype=torch.float32)
ECFG = tch.eagle_config_for_tree(
    teagle.EagleConfig(**{f.name: getattr(JECFG, f.name)
                          for f in dataclasses.fields(JECFG)
                          if f.name != "dtype"}, dtype=torch.float32), TREE)


@pytest.mark.parametrize("choices", [
    jch.mc_sim_7b_63, [[0], [1], [0, 0], [0, 1], [1, 0], [0, 0, 0]]])
def test_tree_buffers_equal(choices):
    want, got = jch.build_tree_buffers(choices), tch.build_tree_buffers(
        choices)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert b.dtype == a.dtype, f.name
            np.testing.assert_array_equal(b, a, f.name)
        else:
            assert b == a, f.name


def test_orphan_choice_rejected():
    with pytest.raises(ValueError, match="orphan"):
        tch.build_tree_buffers([[0], [1, 0]])


@pytest.fixture(scope="module")
def models():
    jt = jtr.init_params(JCFG, jax.random.PRNGKey(0))
    jh = jeagle.init_eagle_params(JECFG, jax.random.PRNGKey(1))
    return dict(jt=jt, jh=jh, tt=bridge.params_from_jax(jt),
                th=bridge.eagle_params_from_jax(jh))


def test_eagle_config_for_tree():
    for f in dataclasses.fields(JECFG):
        if f.name != "dtype":
            assert getattr(ECFG, f.name) == getattr(JECFG, f.name), f.name
    assert (ECFG.total_tokens, ECFG.depth, ECFG.top_k) == (25, 5, 10)


def test_build_static_trie_identical(models):
    rng = np.random.default_rng(30)
    T = 6
    feats = rng.standard_normal((2, T, 96)).astype(np.float32)
    toks = rng.integers(0, 64, size=(2, T)).astype(np.int32)
    prefix = np.array([0, 4], np.int32)
    start = np.array([0, 3], np.int32)
    roots = np.array([7, 12], np.int32)
    tkv = teagle.init_eagle_kv(ECFG, 2, 96, "cpu")._replace(
        start=torch.from_numpy(start).long(),
        length=torch.from_numpy(prefix).long())
    trie, tkv2 = tch.build_static_trie(
        ECFG, models["th"], torch.from_numpy(feats),
        torch.from_numpy(toks).long(), tkv, torch.from_numpy(prefix).long(),
        torch.from_numpy(roots).long(), TREE)
    jbuild = jax.jit(lambda *a: jch.build_static_trie(JECFG, *a, JTREE))
    for b in range(2):
        jkv = jeagle.init_eagle_kv(JECFG, 1, 96)._replace(
            start=jnp.int32(start[b]), length=jnp.int32(prefix[b]))
        jt, jkv2 = jbuild(
            models["jh"], jnp.asarray(feats[b:b + 1]),
            jnp.asarray(toks[b:b + 1]), jkv, jnp.int32(prefix[b]),
            jnp.int32(roots[b]))
        for f in teagle.Trie._fields:
            np.testing.assert_array_equal(getattr(trie, f)[b].numpy(),
                                          np.asarray(getattr(jt, f)),
                                          err_msg=f"row {b} {f}")
        n = int(jkv2.length)
        assert int(tkv2.length[b]) == n == prefix[b] + T
        np.testing.assert_allclose(tkv2.k[b, :n].numpy(),
                                   np.asarray(jkv2.k)[0, :n], atol=1e-5)
    # siblings carry distinct tokens (distinct ranks of one distribution)
    for b in range(2):
        toks_b = trie.draft_tokens[b].tolist()
        for p in range(TREE.num_nodes + 1):
            kids = [toks_b[i] for i in range(1, TREE.num_nodes + 1)
                    if TREE.parents[i] == p]
            assert len(set(kids)) == len(kids)


def test_static_tree_greedy_equals_jax_and_ar(models):
    prompt = (np.arange(9) % 50 + 1).astype(np.int32)
    jres = j_generate(JCFG, JECFG, JEng(max_new_tokens=16, temperature=0.0),
                      mode="greedy", static_tree=JTREE)(
        models["jt"], models["jh"], jnp.asarray(prompt), jnp.int32(9),
        jax.random.PRNGKey(5))
    eng = EngineConfig(max_new_tokens=16, temperature=0.0)
    res = make_eagle_generate(CFG, ECFG, eng, mode="greedy",
                              static_tree=TREE)(
        models["tt"], models["th"], torch.from_numpy(prompt).long(), 9, None)
    assert (res.length, res.blocks) == (int(jres.length), int(jres.blocks))
    got = res.tokens[9:res.length].tolist()
    assert got == np.asarray(jres.tokens)[9:res.length].tolist()
    toks, length = make_autoregressive(CFG, eng)(
        models["tt"], torch.from_numpy(prompt).long(), 9, None)
    assert got == toks[9:length].tolist()[:len(got)] and len(got) == 16


def _noise(kind, key, R, L):
    """The uniforms verify_trie_typical / verify_trie_hsd draw from key."""
    f = jax.random.fold_in
    if kind == "typical":
        return {"u": jnp.stack([
            jnp.stack([jax.random.uniform(f(key, i * R + j)) for j in range(R)])
            for i in range(1, L)])}
    return {"u": jnp.stack([jax.random.uniform(f(key, 2 * b), (L,))
                            for b in range(R)]),
            "u2": jnp.stack([jax.random.uniform(f(key, 2 * b + 1))
                             for b in range(R)])}


@pytest.mark.parametrize("kind", ["typical", "hsd"])
def test_static_tree_verifier_decisions_identical(kind):
    """The static tree's candidate paths (random tokens, siblings distinct)
    under target rows that favour the drafted children, 40 problems."""
    R, L = TREE.num_nodes + 1, TREE.depth + 2
    ri = TREE.retrieve_indices
    rng = np.random.default_rng({"typical": 31, "hsd": 32}[kind])
    jfn = jax.jit(jax.vmap(lambda k, c, p, r: (
        jtrie.verify_trie_typical if kind == "typical"
        else jtrie.verify_trie_hsd)(k, c, (p, r))))
    jnz = jax.jit(jax.vmap(lambda k: _noise(kind, k, R, L)))
    B, V = 40, 16
    toks = np.zeros((B, R), np.int32)
    probs = rng.dirichlet(np.full(V, 0.5), size=(B, R)).astype(np.float32)
    for b in range(B):
        for p in range(R):
            kids = [i for i in range(1, R) if TREE.parents[i] == p]
            vals = rng.choice(V, size=len(kids), replace=False)
            toks[b, kids] = vals
            probs[b, p, vals] += rng.choice([0.0, 1.0, 4.0], size=len(kids))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    cand = np.where(ri >= 0, toks[:, np.clip(ri, 0, R - 1)], -1)
    ris = np.broadcast_to(ri, (B, R, L)).copy()
    keys = jax.random.split(jax.random.PRNGKey(33), B)
    jb, ja, js = jfn(keys, jnp.asarray(cand), jnp.asarray(probs),
                     jnp.asarray(ris))
    noise = {k: torch.from_numpy(np.array(v)) for k, v in jnz(keys).items()}
    tp = (torch.from_numpy(probs), torch.from_numpy(ris).long())
    tc = torch.from_numpy(cand).long()
    if kind == "typical":
        tb, ta, ts = ttrie.verify_trie_typical(tc, tp, noise=noise)
    else:
        tb, ta, ts = ttrie.verify_trie_hsd(tc, tp, noise=noise)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    assert int((ta > 0).sum()) > B // 4          # the rules were exercised
