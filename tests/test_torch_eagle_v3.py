"""Port parity of the EAGLE-3 (v3) head against the JAX package on the CPU,
at tiny float32 sizes, with weights carried across by the bridge.

* EagleConfig.from_json reads a config file field by field as the JAX
  package does.
* quantize_eagle_params: codes and scales bit for bit, the dense fields
  untouched.
* head_forward and draft_logp within 1e-5; build_trie (absorb through fc
  of the three feature layers, then the beam) with identical tokens,
  parents, masks, depths and retrieve indices and the head KV within 1e-5,
  for the dense and the int8-quantized head.
* Greedy make_eagle_generate over a plain target with its three feature
  taps: the JAX stream, and the target's own greedy AR stream, for the
  dense and the quantized head.
* EagleSlotEngine with a v3 head: every greedy request gives its AR
  stream; its feature buffer is 3 * Dt wide.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.config import EngineConfig as JEng
from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.engine.eagle_engine import make_eagle_generate as j_generate
from hsd_tpu.models import eagle as jeagle
from hsd_tpu.models import transformer as jtr
from hsd_tpu.ops.linear import QuantizedLinear as JQL
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, ModelConfig
from hsd_tpu_torch.engine import make_autoregressive
from hsd_tpu_torch.engine.eagle_engine import (default_feature_layers,
                                               make_eagle_generate)
from hsd_tpu_torch.engine.eagle_server import EagleSlotEngine
from hsd_tpu_torch.models import eagle as teagle
from hsd_tpu_torch.ops.linear import QuantizedLinear

torch.set_num_threads(2)
JCFG = JCfg.tiny(vocab_size=64, hidden_size=32, intermediate_size=64,
                 num_layers=4, num_heads=4, num_kv_heads=2,
                 dtype=jnp.float32)
JECFG = jeagle.EagleConfig(hidden_size=32, target_hidden_size=32,
                           num_heads=4, num_kv_heads=2, vocab_size=64,
                           draft_vocab_size=48, intermediate_size=64,
                           top_k=4, depth=3, total_tokens=11,
                           dtype=jnp.float32, rope_theta=10000.0)
CFG = ModelConfig(**{f: getattr(JCFG, f) for f in (
    "vocab_size", "hidden_size", "intermediate_size", "num_layers",
    "num_heads", "num_kv_heads", "rope_theta", "rms_norm_eps",
    "tie_word_embeddings", "attention_bias", "eos_token_id")},
    dtype=torch.float32)
ECFG = teagle.EagleConfig(**{f.name: getattr(JECFG, f.name)
                             for f in dataclasses.fields(JECFG)
                             if f.name != "dtype"}, dtype=torch.float32)
PROMPT = (np.arange(8) % 50 + 1).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    jt = jtr.init_params(JCFG, jax.random.PRNGKey(0))
    jh = jeagle.init_eagle_params(JECFG, jax.random.PRNGKey(1))
    # a reduced draft vocab: draft id i is target id i + d2t[i]
    jh = jh._replace(d2t=jnp.arange(48, dtype=jnp.int32) % 3 * 5)
    jq = jeagle.quantize_eagle_params(jh, bits=8)
    return dict(jt=jt, jh=jh, jq=jq, tt=bridge.params_from_jax(jt),
                th=bridge.eagle_params_from_jax(jh),
                tq=bridge.eagle_params_from_jax(jq))


def test_from_json_reads_every_field(tmp_path):
    cfg = {"hidden_size": 4096, "num_attention_heads": 32,
           "num_key_value_heads": 8, "intermediate_size": 14336,
           "vocab_size": 128256, "draft_vocab_size": 32000,
           "rms_norm_eps": 1e-05, "rope_theta": 500000.0,
           "target_hidden_size": 4096, "architectures": ["LlamaForCausalLM"]}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    want = jeagle.EagleConfig.from_json(str(path), top_k=8)
    got = teagle.EagleConfig.from_json(str(path), top_k=8)
    for f in dataclasses.fields(got):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.head_dim == 128 and got.version == 3 and got.top_k == 8
    # the reference's defaults for the optional fields
    path.write_text(json.dumps({"hidden_size": 64, "num_attention_heads": 4,
                                "vocab_size": 100}))
    small = teagle.EagleConfig.from_json(str(path))
    assert (small.target_hidden_size, small.num_kv_heads,
            small.draft_vocab_size, small.rms_norm_eps, small.rope_theta,
            small.intermediate_size) == (64, 4, 100, 1e-5, 500000.0, 0)


def test_quantize_eagle_params_bit_exact(models):
    got = teagle.quantize_eagle_params(models["th"], bits=8)
    for f in teagle.EagleParams._fields:
        a, b = getattr(models["jq"], f), getattr(got, f)
        if isinstance(a, JQL):
            assert isinstance(b, QuantizedLinear) and b.zeros is None, f
            np.testing.assert_array_equal(b.qweight.numpy(),
                                          np.asarray(a.qweight), f)
            np.testing.assert_array_equal(b.scales.numpy(),
                                          np.asarray(a.scales), f)
        elif a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), f)
    # groups of gcd(rows, 128): fc's 96 rows form 3 groups
    assert got.fc.scales.shape == (3, 32)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("head", ["dense", "int8"])
def test_head_forward_and_draft_logp(models, head):
    jh, th = ((models["jh"], models["th"]) if head == "dense"
              else (models["jq"], models["tq"]))
    rng = np.random.default_rng(20)
    T = 5
    emb = rng.standard_normal((1, T, 32)).astype(np.float32)
    hid = rng.standard_normal((1, T, 32)).astype(np.float32)
    pos = np.arange(3, 3 + T, dtype=np.int32)[None]
    jkv = jeagle.init_eagle_kv(JECFG, 1, 16)._replace(length=jnp.int32(3))
    jo, jkv2 = jeagle.head_forward(JECFG, jh, jnp.asarray(emb),
                                   jnp.asarray(hid), jkv, jnp.asarray(pos))
    tkv = teagle.init_eagle_kv(ECFG, 1, 16, "cpu")._replace(
        length=torch.tensor([3]))
    to, tkv2 = teagle.head_forward(ECFG, th, torch.from_numpy(emb),
                                   torch.from_numpy(hid), tkv,
                                   torch.from_numpy(pos).long())
    np.testing.assert_allclose(_np(to), np.asarray(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tkv2.k[0]), np.asarray(jkv2.k)[0],
                               rtol=1e-5, atol=1e-5)
    assert int(tkv2.length[0]) == int(jkv2.length) == 3 + T
    np.testing.assert_allclose(
        _np(teagle.draft_logp(ECFG, th, to)),
        np.asarray(jeagle.draft_logp(JECFG, jh, jo)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("head", ["dense", "int8"])
def test_build_trie_identical(models, head):
    """Two rows with different prefixes, frontiers and left pads, each
    against one JAX call, over two successive tries; the feature stream is
    the three layers' inputs (3 * Dt)."""
    jh, th = ((models["jh"], models["th"]) if head == "dense"
              else (models["jq"], models["tq"]))
    rng = np.random.default_rng(21)
    T = 6
    prefix = np.array([0, 5], np.int32)
    start = np.array([0, 2], np.int32)
    roots = np.array([7, 30], np.int32)
    jkvs = [jeagle.init_eagle_kv(JECFG, 1, 64)._replace(
        start=jnp.int32(start[b])) for b in range(2)]
    tkv = teagle.init_eagle_kv(ECFG, 2, 64, "cpu")._replace(
        start=torch.from_numpy(start).long())
    jbuild = jax.jit(lambda *a: jeagle.build_trie(JECFG, *a))
    for step in range(2):
        feats = rng.standard_normal((2, T, 96)).astype(np.float32)
        toks = rng.integers(0, 64, size=(2, T)).astype(np.int32)
        want = [jbuild(jh, jnp.asarray(feats[b:b + 1]),
                                  jnp.asarray(toks[b:b + 1]),
                                  jkvs[b]._replace(length=jnp.int32(prefix[b])),
                                  jnp.int32(prefix[b]), jnp.int32(roots[b]))
                for b in range(2)]
        trie, tkv = teagle.build_trie(
            ECFG, th, torch.from_numpy(feats), torch.from_numpy(toks).long(),
            tkv._replace(length=torch.from_numpy(prefix).long()),
            torch.from_numpy(prefix).long(), torch.from_numpy(roots).long())
        for b, (jt, jkv) in enumerate(want):
            for f in teagle.Trie._fields:
                np.testing.assert_array_equal(
                    getattr(trie, f)[b].numpy(), np.asarray(getattr(jt, f)),
                    err_msg=f"{head} step {step} row {b} {f}")
            assert int(tkv.length[b]) == int(jkv.length)
            n = int(jkv.length)
            np.testing.assert_allclose(tkv.k[b, :n].numpy(),
                                       np.asarray(jkv.k)[0, :n], atol=1e-5)
            jkvs[b] = jkv
        prefix = prefix + T


def _ar(models, prompt, plen, max_new):
    eng = EngineConfig(max_new_tokens=max_new, temperature=0.0)
    toks, length = make_autoregressive(CFG, eng)(
        models["tt"], torch.from_numpy(prompt).long(), plen, None)
    return toks[len(prompt):length].tolist()


@pytest.mark.parametrize("head", ["dense", "int8"])
def test_greedy_generate_equals_jax_and_ar(models, head):
    jh, th = ((models["jh"], models["th"]) if head == "dense"
              else (models["jq"], models["tq"]))
    jres = j_generate(JCFG, JECFG, JEng(max_new_tokens=12, temperature=0.0),
                      mode="greedy")(models["jt"], jh, jnp.asarray(PROMPT),
                                     jnp.int32(8), jax.random.PRNGKey(5))
    res = make_eagle_generate(CFG, ECFG, EngineConfig(max_new_tokens=12,
                                                      temperature=0.0),
                              mode="greedy")(models["tt"], th,
                                             torch.from_numpy(PROMPT).long(),
                                             8, None)
    assert (res.length, res.blocks) == (int(jres.length), int(jres.blocks))
    got = res.tokens[8:res.length].tolist()
    assert got == np.asarray(jres.tokens)[8:res.length].tolist()
    np.testing.assert_array_equal(res.accepts[:res.blocks].numpy(),
                                  np.asarray(jres.accepts)[:res.blocks])
    assert got == _ar(models, PROMPT, 8, 12)[:len(got)] and len(got) == 12


def test_server_v3_greedy_matches_ar(models):
    assert default_feature_layers(CFG) == (2, 2, 1)
    se = EagleSlotEngine(CFG, ECFG, EngineConfig(max_new_tokens=8,
                                                 temperature=0.0),
                         n_slots=2, bucket=12, params_t=models["tt"],
                         params_e=models["tq"], mode="greedy", seed=3,
                         steps_per_dispatch=2, device="cpu")
    prompts = [list(range(3 + i, 10 + i)) for i in range(4)]
    for rid, p in enumerate(prompts):
        se.submit(rid, p, max_new=8)
    done = se.run_all()
    assert sorted(r.rid for r in done) == [0, 1, 2, 3]
    assert se.state["feat_buf"].shape[-1] == 3 * 32
    for r in done:
        p = prompts[r.rid]
        padded = np.asarray([0] * (12 - len(p)) + p, np.int32)
        assert r.out_tokens == _ar(models, padded, len(p), 8), r.rid
