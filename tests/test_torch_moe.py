"""Port parity of the Mixtral family's sparse-MoE decoder against the JAX
package (the cases of tests/test_moe.py without its mesh cases).

* `_moe_ffn` against the JAX one and against a per-token top-k loop (the
  reference's MixtralSparseMoeBlock semantics), f32, rtol 1e-4 / atol
  1e-5 as the JAX file; the router's logits and top-k bit for bit across
  row counts.
* The MoE forward: decode == prefill, the logits of JAX's forward on
  bridged weights, dense and with quantized expert stacks (packed int4 and
  int8, symmetric and asymmetric, with an [L, E, in] perm) within the
  port's f32 logit tolerance (rtol = atol = 2e-3, as
  tests/test_torch_model.py), and `forward(hidden_in=..., skip_head=True)`.
* Greedy speculative decoding and greedy EAGLE over an MoE base equal AR
  and the JAX package's streams.
* `QuantizedLinear.layer` on a [L, E, ...] stack with a perm: views equal
  to the JAX slice; the synthetic quantized MoE weights of the card run
  (eval/synthetic) give the JAX forward's logits when carried to JAX.
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
from hsd_tpu.engine import init_cache as j_init_cache
from hsd_tpu.engine import make_generate as j_make_generate
from hsd_tpu.engine.eagle_engine import make_eagle_generate as j_eagle_gen
from hsd_tpu.models import eagle as jeagle
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu.models import transformer as jtr
from hsd_tpu.ops.linear import QuantizedLinear as JQL
from hsd_tpu.ops.linear import quantize as j_quantize
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine import make_autoregressive, make_generate
from hsd_tpu_torch.engine.eagle_engine import make_eagle_generate
from hsd_tpu_torch.engine.kvcache import init_cache
from hsd_tpu_torch.eval.synthetic import init_quantized_params
from hsd_tpu_torch.models import eagle as teagle
from hsd_tpu_torch.models import transformer as ttr
from hsd_tpu_torch.ops.linear import QuantizedLinear, apply_linear

torch.set_num_threads(2)
TOL = dict(rtol=2e-3, atol=2e-3)
FFN_TOL = dict(rtol=1e-4, atol=1e-5)
JCFG = JCfg.tiny_moe(vocab_size=256, num_heads=8, num_kv_heads=4,
                     hidden_size=64, intermediate_size=96)


def _tcfg(jcfg):
    """The port's config for a JAX config (same fields, float32)."""
    return ModelConfig(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "head_dim", "rope_theta",
        "rms_norm_eps", "tie_word_embeddings", "attention_bias",
        "eos_token_id", "num_experts", "num_experts_per_tok")},
        dtype=torch.float32)


CFG = _tcfg(JCFG)


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _per_token_loop(x, lp, K):
    """The reference's routing, token by token (modeling_mixtral_kv.py:
    477-513): f32 softmax over all experts, top-k, renormalized, a
    weighted sum of the chosen experts' SwiGLUs."""
    probs = _softmax(x @ lp["gate"])
    want = np.zeros_like(x)
    for n in range(x.shape[0]):
        idx = np.argsort(-probs[n])[:K]
        w = probs[n, idx] / probs[n, idx].sum()
        for wj, e in zip(w, idx):
            a = x[n] @ lp["wgate"][e]
            a = a / (1 + np.exp(-a)) * (x[n] @ lp["wup"][e])
            want[n] += wj * (a @ lp["wdown"][e])
    return want


def test_config_presets_match_jax():
    for name in ("mixtral_8x7b", "tiny_moe"):
        j, t = getattr(JCfg, name)(), getattr(ModelConfig, name)()
        for f in dataclasses.fields(t):
            if f.name not in ("dtype", "gptq_mxu_bf16"):
                assert getattr(t, f.name) == getattr(j, f.name), (name, f)
        assert t.is_moe and j.is_moe
    assert ModelConfig.tiny_moe().dtype == torch.float32
    assert not ModelConfig.tiny().is_moe


def test_moe_ffn_matches_jax_and_per_token_loop():
    rng = np.random.default_rng(0)
    N, D, F, E, K = 7, 16, 24, 4, 2
    jcfg = JCfg.tiny_moe(hidden_size=D, intermediate_size=F, num_experts=E,
                         num_experts_per_tok=K)
    h = rng.normal(size=(1, N, D)).astype(np.float32)
    lp = dict(gate=rng.normal(size=(D, E)).astype(np.float32),
              wgate=rng.normal(size=(E, D, F)).astype(np.float32) * 0.2,
              wup=rng.normal(size=(E, D, F)).astype(np.float32) * 0.2,
              wdown=rng.normal(size=(E, F, D)).astype(np.float32) * 0.2)
    got = ttr._moe_ffn(_tcfg(jcfg), {k: torch.from_numpy(v)
                                     for k, v in lp.items()},
                       torch.from_numpy(h)).numpy()[0]
    want_j = np.asarray(jtr._moe_ffn(jcfg, {k: jnp.asarray(v)
                                            for k, v in lp.items()},
                                     jnp.asarray(h)))[0]
    np.testing.assert_allclose(got, want_j, **FFN_TOL)
    np.testing.assert_allclose(got, _per_token_loop(h[0], lp, K), **FFN_TOL)


def test_router_bits_do_not_depend_on_row_count():
    """A row's router logits, top-k and weights are the same bits at 1, 11
    and 64 rows (every sum in one fixed order)."""
    rng = np.random.default_rng(1)
    D, E = 256, 8
    cfg = ModelConfig.tiny_moe(hidden_size=D, num_experts=E)
    x = torch.from_numpy(rng.normal(size=(64, D)).astype(np.float32))
    gate = torch.from_numpy(rng.normal(size=(D, E)).astype(np.float32)
                            * D ** -0.5)
    full = ttr.moe_route(cfg, gate, x)
    for n in (1, 11):
        part = ttr.moe_route(cfg, gate, x[-n:])
        for a, b in zip(part, full):
            assert torch.equal(a, b[-n:])
    logits = full[0].numpy()
    np.testing.assert_allclose(logits, x.numpy() @ gate.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def moe_pair():
    jp = j_init_params(JCFG, jax.random.PRNGKey(0))
    return jp, bridge.params_from_jax(jp)


def test_moe_decode_matches_prefill_and_jax(moe_pair):
    jp, tp = moe_pair
    toks = ((np.arange(8) % 50) + 1).reshape(1, 8)
    tt = torch.from_numpy(toks).long()
    full, _ = ttr.forward(CFG, tp, tt, init_cache(CFG, 1, 16, "cpu"))
    c = init_cache(CFG, 1, 16, "cpu")
    _, c = ttr.forward(CFG, tp, tt[:, :5], c)
    part, _ = ttr.forward(CFG, tp, tt[:, 5:], c)
    np.testing.assert_allclose(part.numpy(), full[:, 5:].numpy(),
                               rtol=2e-4, atol=2e-4)
    jfull, _ = jtr.forward(JCFG, jp, jnp.asarray(toks, jnp.int32),
                           j_init_cache(JCFG, 1, 16))
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), **TOL)


def test_hidden_in_skip_head_matches_jax(moe_pair):
    jp, tp = moe_pair
    rng = np.random.default_rng(2)
    toks = ((np.arange(12) % 50) + 1).reshape(2, 6)
    h = rng.normal(size=(2, 6, JCFG.hidden_size)).astype(np.float32)
    jout, jc = jtr.forward(JCFG, jp, jnp.asarray(toks, jnp.int32),
                           j_init_cache(JCFG, 2, 8), hidden_in=jnp.asarray(h),
                           skip_head=True)
    tout, tc = ttr.forward(CFG, tp, torch.from_numpy(toks).long(),
                           init_cache(CFG, 2, 8, "cpu"),
                           hidden_in=torch.from_numpy(h), skip_head=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    # the embedding of `tokens` is not read
    other, _ = ttr.forward(CFG, tp, torch.zeros_like(torch.from_numpy(toks))
                           .long(), init_cache(CFG, 2, 8, "cpu"),
                           hidden_in=torch.from_numpy(h), skip_head=True)
    assert torch.equal(other, tout)


def _quantized_moe(jp, bits, symmetric, perm, seed=4):
    """JAX params with every expert of every layer quantized; with perm,
    each (layer, expert) matrix has its rows in a random order and the
    order kept in an [L, E, in] perm."""
    rng = np.random.default_rng(seed)
    layers = dict(jp.layers)
    for name in ("wgate", "wup", "wdown"):
        w = np.asarray(layers[name])
        L, E, din, _ = w.shape
        qs = []
        for l in range(L):
            for e in range(E):
                p = rng.permutation(din) if perm else np.arange(din)
                q = j_quantize(jnp.asarray(w[l, e][p]), bits=bits,
                               group_size=64 if bits == 4 else 128,
                               symmetric=symmetric)
                qs.append(q._replace(perm=jnp.asarray(p, jnp.int32)
                                     if perm else None))
        st = lambda f: (None if getattr(qs[0], f) is None else jnp.stack(
            [getattr(q, f) for q in qs]).reshape(
                (L, E) + getattr(qs[0], f).shape))
        layers[name] = JQL(qweight=st("qweight"), scales=st("scales"),
                           zeros=st("zeros"), perm=st("perm"))
    return jp._replace(layers=layers)


@pytest.mark.parametrize("bits,symmetric,perm", [
    (4, True, True), (4, False, False), (8, True, False), (8, False, True)])
def test_quantized_expert_stacks_match_jax(bits, symmetric, perm):
    jcfg = JCfg.tiny_moe(vocab_size=128, hidden_size=128,
                         intermediate_size=256, num_heads=4, num_kv_heads=2)
    jp = _quantized_moe(j_init_params(jcfg, jax.random.PRNGKey(1)), bits,
                        symmetric, perm)
    tp = bridge.params_from_jax(jp)
    w = tp.layers["wdown"]
    assert isinstance(w, QuantizedLinear) and w.qweight.dim() == 4
    assert (w.perm is not None) == perm
    toks = ((np.arange(12) % 100) + 3).reshape(2, 6)
    jl, _ = jtr.forward(jcfg, jp, jnp.asarray(toks, jnp.int32),
                        j_init_cache(jcfg, 2, 8))
    cfg = _tcfg(jcfg)
    tl, _ = ttr.forward(cfg, tp, torch.from_numpy(toks).long(),
                        init_cache(cfg, 2, 8, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_expert_views_equal_jax_slices():
    """`w.layer(l).layer(e)` of a stacked quantized weight with an
    [L, E, in] perm is the JAX slice a[l][e] of every field, as views."""
    jcfg = JCfg.tiny_moe(vocab_size=64, hidden_size=128,
                         intermediate_size=128, num_heads=4, num_kv_heads=2)
    jp = _quantized_moe(j_init_params(jcfg, jax.random.PRNGKey(2)), 4, False,
                        True)
    jw = jp.layers["wup"]
    tw = bridge.convert(jw)
    for l in range(2):
        for e in range(4):
            v = tw.layer(l).layer(e)
            for f in ("qweight", "scales", "zeros", "perm"):
                got, want = getattr(v, f), np.asarray(getattr(jw, f)[l, e])
                np.testing.assert_array_equal(got.numpy(), want)
                assert (got.untyped_storage().data_ptr()
                        == getattr(tw, f).untyped_storage().data_ptr())
    # a shared [in] perm is kept as it is by every layer
    shared = tw._replace(perm=tw.perm[0, 0])
    assert shared.layer(1).layer(2).perm is shared.perm
    x = torch.ones((3, 128))
    with pytest.raises(ValueError):
        apply_linear(tw, x, layer=0)       # an [E, ...] stack, not a matrix
    y = apply_linear(tw.layer(1).layer(3), x)
    assert y.shape == (3, 128)


def _greedy_engines(gamma=3, max_new=12):
    return (JEng(verifier=JVer(method="greedy", gamma=gamma),
                 max_new_tokens=max_new, temperature=0.0),
            EngineConfig(verifier=VerifierConfig(method="greedy",
                                                 gamma=gamma),
                         max_new_tokens=max_new, temperature=0.0))


def test_moe_speculative_greedy_equals_ar_and_jax(moe_pair):
    jp, tp = moe_pair
    jdcfg = JCfg.tiny(vocab_size=256)
    jd = j_init_params(jdcfg, jax.random.PRNGKey(3))
    td, dcfg = bridge.params_from_jax(jd), _tcfg(jdcfg)
    jeng, teng = _greedy_engines()
    prompt = ((np.arange(8) % 50) + 1).astype(np.int32)
    jres = j_make_generate(jdcfg, JCFG, jeng)(
        jd, jp, jnp.asarray(prompt), jnp.int32(8), jax.random.PRNGKey(7))
    tres = make_generate(dcfg, CFG, teng)(
        td, tp, torch.from_numpy(prompt).long(), 8, None)
    assert tres.length == int(jres.length) > 8
    np.testing.assert_array_equal(tres.tokens[8:tres.length].numpy(),
                                  np.asarray(jres.tokens)[8:tres.length])
    toks, length = make_autoregressive(CFG, teng)(
        tp, torch.from_numpy(prompt).long(), 8, None)
    n = min(tres.length, length)
    np.testing.assert_array_equal(tres.tokens[8:n].numpy(),
                                  toks[8:n].numpy())
    # hsd over the MoE target is reproducible from its generator
    eng = EngineConfig(verifier=VerifierConfig(method="hsd", gamma=3),
                       max_new_tokens=12)
    gen = make_generate(dcfg, CFG, eng)
    r1, r2 = (gen(td, tp, torch.from_numpy(prompt).long(), 8,
                  torch.Generator().manual_seed(7)) for _ in range(2))
    assert r1.length > 8 and torch.equal(r1.tokens, r2.tokens)


def test_eagle_over_moe_base_greedy_equals_ar():
    jtcfg = JCfg.tiny_moe(vocab_size=64, hidden_size=32, intermediate_size=64,
                          num_layers=4, num_heads=4, num_kv_heads=2)
    jecfg = jeagle.EagleConfig(hidden_size=32, target_hidden_size=32,
                               num_heads=4, num_kv_heads=2, vocab_size=64,
                               draft_vocab_size=64, intermediate_size=64,
                               top_k=4, depth=3, total_tokens=11,
                               dtype=jnp.float32, rope_theta=10000.0)
    pt = j_init_params(jtcfg, jax.random.PRNGKey(0))
    pe = jeagle.init_eagle_params(jecfg, jax.random.PRNGKey(1))
    prompt = ((np.arange(8) % 50) + 1).astype(np.int32)
    jeng = JEng(max_new_tokens=10, temperature=0.0)
    jres = j_eagle_gen(jtcfg, jecfg, jeng, mode="greedy")(
        pt, pe, jnp.asarray(prompt), jnp.int32(8), jax.random.PRNGKey(5))
    tcfg = _tcfg(jtcfg)
    tecfg = teagle.EagleConfig(**{f.name: getattr(jecfg, f.name)
                                  for f in dataclasses.fields(jecfg)
                                  if f.name != "dtype"}, dtype=torch.float32)
    teng = EngineConfig(max_new_tokens=10, temperature=0.0)
    tpt, tpe = bridge.params_from_jax(pt), bridge.eagle_params_from_jax(pe)
    tres = make_eagle_generate(tcfg, tecfg, teng, mode="greedy")(
        tpt, tpe, torch.from_numpy(prompt).long(), 8, None)
    assert tres.length == int(jres.length) > 8
    np.testing.assert_array_equal(tres.tokens[8:tres.length].numpy(),
                                  np.asarray(jres.tokens)[8:tres.length])
    toks, length = make_autoregressive(tcfg, teng)(
        tpt, torch.from_numpy(prompt).long(), 8, None)
    n = min(tres.length, length)
    np.testing.assert_array_equal(tres.tokens[8:n].numpy(),
                                  toks[8:n].numpy())


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _params_to_jax(p):
    def conv(v):
        if isinstance(v, QuantizedLinear):
            return JQL(*(None if a is None else _to_jax(a) for a in v))
        if isinstance(v, ttr.QuantizedEmbedding):
            return jtr.QuantizedEmbedding(_to_jax(v.codes), _to_jax(v.scale))
        return _to_jax(v)
    return jtr.ModelParams(embed=conv(p.embed),
                           layers={k: conv(v) for k, v in p.layers.items()},
                           final_norm=conv(p.final_norm),
                           lm_head=conv(p.lm_head))


def test_synthetic_quantized_moe_matches_jax():
    """eval/synthetic's quantized MoE weights: [L, E, ...] packed-int4
    expert stacks and an f32 router beside the fused attention, and the
    port's forward on them gives the JAX forward's logits."""
    cfg = ModelConfig.tiny_moe(vocab_size=128, hidden_size=128,
                               intermediate_size=256, num_heads=4,
                               num_kv_heads=2)
    p = init_quantized_params(cfg, seed=3, bits=4, device="cpu")
    L, E, D, Fi = 2, 4, 128, 256
    assert p.layers["gate"].shape == (L, D, E)
    assert p.layers["gate"].dtype == torch.float32
    for name, din, dout in (("wgate", D, Fi), ("wup", D, Fi),
                            ("wdown", Fi, D)):
        w = p.layers[name]
        assert w.qweight.shape == (L, E, din // 2, dout)
        assert w.qweight.dtype == torch.uint8
        assert w.scales.shape == (L, E, din // 128, dout)
        assert w.scales.dtype == torch.bfloat16 and w.zeros is None
    assert "wgu" not in p.layers and "wqkv" in p.layers
    toks = ((np.arange(10) % 100) + 3).reshape(2, 5)
    jcfg = JCfg.tiny_moe(vocab_size=128, hidden_size=128,
                         intermediate_size=256, num_heads=4, num_kv_heads=2)
    jl, _ = jtr.forward(jcfg, _params_to_jax(p), jnp.asarray(toks, jnp.int32),
                        j_init_cache(jcfg, 2, 8))
    tl, _ = ttr.forward(cfg, p, torch.from_numpy(toks).long(),
                        init_cache(cfg, 2, 8, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
