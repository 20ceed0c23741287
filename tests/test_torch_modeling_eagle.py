"""The port's `Eagle` facade (hsd_tpu_torch/modeling_eagle.py) against the
JAX package's: the four cases of tests/test_modeling_eagle.py on weights
carried by the bridge, and `from_pretrained` on synthesized checkpoints.

* generate / naive_generate, the closure cache; greedy streams equal the
  JAX class's and AR.
* forward_with_tree_mask: a causal mask gives the plain forward (and the
  JAX class's logits within the port's f32 tolerance, rtol = atol =
  2e-3); a sibling's token does not reach a leaf.
* evaluate_posterior: the JAX function's decisions on the uniforms it
  draws (greedy, typical, hsd).
* from_pretrained on a dense base checkpoint and an EAGLE-3 head
  checkpoint: greedy generate == naive_generate == the JAX class built in
  memory from the JAX loaders. (The JAX `from_pretrained` itself raises:
  it keeps load_hf's (cfg, params) pair as the params.)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu.models import loader as jl
from hsd_tpu.models.eagle import EagleConfig as JECfg
from hsd_tpu.models.eagle import init_eagle_params as j_init_eagle
from hsd_tpu.modeling_eagle import Eagle as JEagle
from hsd_tpu.modeling_eagle import evaluate_posterior as j_evaluate
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import ModelConfig
from hsd_tpu_torch.engine.kvcache import init_cache
from hsd_tpu_torch.modeling_eagle import Eagle, evaluate_posterior
from hsd_tpu_torch.models import eagle as teagle
from hsd_tpu_torch.models import transformer as ttr
from test_loader import _write_synthetic_ckpt
from test_torch_loader import _write_eagle3_head

torch.set_num_threads(2)
TOL = dict(rtol=2e-3, atol=2e-3)
JTCFG = JCfg.tiny(vocab_size=64, hidden_size=32, intermediate_size=64,
                  num_layers=3, num_heads=4, num_kv_heads=2)
JECFG = JECfg(hidden_size=32, target_hidden_size=32, num_heads=4,
              num_kv_heads=2, vocab_size=64, draft_vocab_size=64,
              intermediate_size=64, top_k=3, depth=2, total_tokens=5,
              dtype=jnp.float32, rope_theta=10000.0)
TCFG = ModelConfig(**{f: getattr(JTCFG, f) for f in (
    "vocab_size", "hidden_size", "intermediate_size", "num_layers",
    "num_heads", "num_kv_heads", "rope_theta", "rms_norm_eps",
    "tie_word_embeddings", "attention_bias", "eos_token_id")},
    dtype=torch.float32)
TECFG = teagle.EagleConfig(**{f.name: getattr(JECFG, f.name)
                              for f in dataclasses.fields(JECFG)
                              if f.name != "dtype"}, dtype=torch.float32)
PROMPT = np.arange(1, 9) % 50 + 1


@pytest.fixture(scope="module")
def pair():
    pt = j_init_params(JTCFG, jax.random.PRNGKey(0))
    pe = j_init_eagle(JECFG, jax.random.PRNGKey(1))
    return (JEagle(JTCFG, pt, JECFG, pe),
            Eagle(TCFG, bridge.params_from_jax(pt), TECFG,
                  bridge.eagle_params_from_jax(pe)))


def test_generate_and_naive(pair):
    jeagle, eagle = pair
    res = eagle.generate(PROMPT, max_new_tokens=8,
                         generator=torch.Generator().manual_seed(3))
    assert res.ncommit >= 1
    toks = res.tokens[:res.length].numpy()
    np.testing.assert_array_equal(toks[:8], PROMPT)
    out, length = eagle.naive_generate(
        PROMPT, max_new_tokens=8, generator=torch.Generator().manual_seed(4))
    assert length > 8
    # closure caching: a second call reuses the engine, same seed same run
    res2 = eagle.generate(PROMPT, max_new_tokens=8,
                          generator=torch.Generator().manual_seed(3))
    assert torch.equal(res2.tokens, res.tokens)
    assert len(eagle._gen_cache) == 2
    # greedy: the JAX class's stream, and AR's
    g = eagle.generate(PROMPT, max_new_tokens=8, temperature=0.0,
                       mode="greedy")
    jg = jeagle.generate(PROMPT, max_new_tokens=8, temperature=0.0,
                         mode="greedy", key=jax.random.PRNGKey(3))
    assert g.length == int(jg.length) > 8
    np.testing.assert_array_equal(g.tokens[:g.length].numpy(),
                                  np.asarray(jg.tokens)[:g.length])
    ar, ar_len = eagle.naive_generate(PROMPT, max_new_tokens=8,
                                      temperature=0.0)
    n = min(ar_len, g.length)
    assert torch.equal(ar[:n], g.tokens[:n])


def test_forward_with_tree_mask_matches_causal(pair):
    jeagle, eagle = pair
    toks = (torch.arange(6) % 50 + 1)[None, :]
    tri = torch.tril(torch.ones((6, 6), dtype=torch.bool))
    lg_tree, _ = eagle.forward_with_tree_mask(toks, tree_mask=tri)
    lg_ref, _ = ttr.forward(TCFG, eagle.params_target, toks,
                            init_cache(TCFG, 1, 6, "cpu"))
    np.testing.assert_allclose(lg_tree.numpy(), lg_ref.numpy(),
                               rtol=1e-5, atol=1e-5)
    jlg, _ = jeagle.forward_with_tree_mask(
        jnp.asarray(toks.numpy(), jnp.int32),
        tree_mask=jnp.asarray(tri.numpy()))
    np.testing.assert_allclose(lg_tree.numpy(), np.asarray(jlg), **TOL)


def test_forward_with_tree_mask_blocks_nonancestors(pair):
    _, eagle = pair
    toks_a = torch.tensor([[5, 7, 9]])          # root + two siblings
    toks_b = torch.tensor([[5, 8, 9]])          # the other sibling differs
    mask = torch.tensor([[1, 0, 0], [1, 1, 0], [1, 0, 1]], dtype=torch.bool)
    pos = torch.tensor([[0, 1, 1]])
    la, _ = eagle.forward_with_tree_mask(toks_a, tree_mask=mask,
                                         positions=pos)
    lb, _ = eagle.forward_with_tree_mask(toks_b, tree_mask=mask,
                                         positions=pos)
    np.testing.assert_allclose(la[0, 2].numpy(), lb[0, 2].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not np.allclose(la[0, 1].numpy(), lb[0, 1].numpy())


def _jax_noise(mode, key, R, L):
    """The uniforms the JAX trie verifiers draw for one problem."""
    f = jax.random.fold_in
    if mode == "typical":
        return {"u": jnp.stack([jnp.stack([
            jax.random.uniform(f(key, i * R + j)) for j in range(R)])
            for i in range(1, L)])}
    return {"u": jnp.stack([jax.random.uniform(f(key, 2 * b), (L,))
                            for b in range(R)]),
            "u2": jnp.stack([jax.random.uniform(f(key, 2 * b + 1))
                             for b in range(R)])}


def test_evaluate_posterior_dispatch():
    key = jax.random.PRNGKey(0)
    cand = jnp.asarray([[3, 1, -1], [3, 2, 4]], jnp.int32)
    p = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(1), (2, 3, 8)),
                       -1)
    tc, tp = torch.from_numpy(np.array(cand)).long(), \
        torch.from_numpy(np.array(p))
    for mode in ("greedy", "typical", "hsd"):
        jb, ja, js = j_evaluate(key, cand, p, mode=mode)
        noise = (None if mode == "greedy" else
                 {k: torch.from_numpy(np.array(v))
                  for k, v in _jax_noise(mode, key, 2, 3).items()})
        best, acc, sp = evaluate_posterior(tc, tp, mode=mode, noise=noise)
        assert int(best) == int(jb) and int(acc) == int(ja), mode
        np.testing.assert_allclose(sp.numpy(), np.asarray(js), atol=1e-6)
        assert 0 <= int(best) < 2 and 0 <= int(acc) <= 2
        np.testing.assert_allclose(float(sp.sum()), 1.0, atol=1e-4)
    with pytest.raises(ValueError):
        evaluate_posterior(tc, tp, mode="nope")


def test_from_pretrained_greedy_generate_equals_naive(tmp_path):
    base, head = str(tmp_path / "base"), str(tmp_path / "head")
    (tmp_path / "base").mkdir()
    _write_synthetic_ckpt(base, JTCFG)
    _write_eagle3_head(head, np.random.default_rng(2), D=32, Dt=32, V=64,
                       Vd=48)
    over = dict(top_k=3, depth=2, total_tokens=5)
    eagle = Eagle.from_pretrained(base, head, mode="greedy",
                                  dtype=torch.float32, device="cpu", **over)
    assert eagle.cfg_target.dtype == torch.float32
    assert eagle.ecfg.draft_vocab_size == 48 and eagle.ecfg.total_tokens == 5
    res = eagle.generate(PROMPT, max_new_tokens=10, temperature=0.0)
    toks, length = eagle.naive_generate(PROMPT, max_new_tokens=10,
                                        temperature=0.0)
    assert res.length == length > 8
    assert torch.equal(res.tokens[:length], toks[:length])

    # the JAX class built in memory from the JAX loaders gives that stream
    jcfg, jpt = jl.load_hf(base, dataclasses.replace(
        jl.config_from_hf(base), dtype=jnp.float32))
    jecfg = JECfg.from_json(f"{head}/config.json", target_hidden_size=32,
                            dtype=jnp.float32, **over)
    jeagle = JEagle(jcfg, jpt, jecfg,
                    jl.load_eagle_hf(head, jpt.embed, dtype=jnp.float32),
                    mode="greedy")
    jres = jeagle.generate(PROMPT, max_new_tokens=10, temperature=0.0,
                           key=jax.random.PRNGKey(0))
    np.testing.assert_array_equal(res.tokens[:length].numpy(),
                                  np.asarray(jres.tokens)[:length])
    # the reference's from_pretrained keeps load_hf's (cfg, params) pair
    with pytest.raises(AttributeError):
        JEagle.from_pretrained(base, head, dtype=jnp.float32, **over)
