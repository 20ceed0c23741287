"""Port parity of the EAGLE path's kernels, routes, cache operations and
forward hooks against the JAX package on the CPU.

* K5 (symmetric int8 with the RMSNorm fused) and K7 (bf16 operands, f32
  accumulation) as plain versions, against the Pallas kernels in interpret
  mode. K5: within 3e-4 of the output's max magnitude (f32 summation
  order). K7: within 1e-5 of sum |x * w| per output (the measure of
  tests/test_bf16_mxu.py), a limit that f32 operands fail.
* apply_linear's routes: which plain version each case takes.
* The two tree-path compactions the engines use: exact.
* transformer.forward with positions, feature_layers, per-row lengths,
  staging and a per-row bias: logits, features (in units of their row RMS)
  and caches within 2e-3 (float32 tiny configs; the int8 one runs the JAX
  side's Pallas route); the last-position head of a prefill.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.engine import kvcache as jkv
from hsd_tpu.models import transformer as jtr
from hsd_tpu.ops import gptq_pallas as jgp
from hsd_tpu.ops import linear as jlin
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import ModelConfig as TCfg
from hsd_tpu_torch.engine import kvcache as tkv
from hsd_tpu_torch.models import transformer as ttr
from hsd_tpu_torch.ops import gptq_cuda as G
from hsd_tpu_torch.ops import linear as tlin

torch.set_num_threads(2)
TOL = dict(rtol=2e-3, atol=2e-3)


def _np(t):
    return t.detach().cpu().float().numpy()


def _sym8(rng, din, dout):
    """Random symmetric int8 weight with bf16 scales, as the EAGLE target's
    (eval/synthetic._init_q)."""
    codes = rng.integers(-127, 128, size=(din, dout)).astype(np.int8)
    scales = (np.abs(rng.standard_normal((din // 128, dout))) * 1e-2
              + 1e-3).astype(np.float32)
    return jlin.QuantizedLinear(qweight=jnp.asarray(codes),
                                scales=jnp.asarray(scales).astype(jnp.bfloat16),
                                zeros=None)


@pytest.mark.parametrize("n", [1, 11, 60])
def test_k5_plain_matches_pallas(n):
    rng = np.random.default_rng(100 + n)
    jq = _sym8(rng, 256, 384)
    x = rng.standard_normal((n, 256)).astype(np.float32)
    ln = (rng.random(256) + 0.5).astype(np.float32)
    want = np.asarray(jgp.gptq_matmul(jnp.asarray(x), jq, ln=jnp.asarray(ln),
                                      ln_eps=1e-5, interpret=True))
    tq = bridge.convert(jq)
    got = _np(G.int8_ln_matmul(torch.from_numpy(x), tq.qweight, tq.scales,
                               torch.from_numpy(ln), 1e-5))
    assert np.abs(got - want).max() <= 3e-4 * np.abs(want).max()


# K7 plain vs Pallas: both round the operands to bf16 and accumulate in
# f32 on the CPU, so they differ in summation order and in the last bit of
# the inverse RMS only (measured: 2.5e-7 of sum |x * w| at K = 256). Skipping
# either rounding moves an output by ~1e-3 of it.
K7_TOL = 1e-5


@pytest.mark.parametrize("with_ln", [False, True])
@pytest.mark.parametrize("n", [129, 160])
def test_k7_plain_matches_pallas(n, with_ln):
    rng = np.random.default_rng(200 + n + int(with_ln))
    jq = _sym8(rng, 256, 256)
    x = rng.standard_normal((n, 256)).astype(np.float32)
    ln = (rng.random(256) + 0.5).astype(np.float32)
    kw = dict(ln=jnp.asarray(ln), ln_eps=1e-5) if with_ln else {}
    want = np.asarray(jgp.gptq_matmul(jnp.asarray(x), jq, interpret=True,
                                      mxu_bf16=True, **kw))
    tq = bridge.convert(jq)
    tx = torch.from_numpy(x)
    tln = torch.from_numpy(ln) if with_ln else None
    got = _np(G.int8_matmul_bf16(tx, tq.qweight, tq.scales, ln=tln,
                                      eps=1e-5))
    xs = G._rms_f32(tx, tln, 1e-5) if with_ln else tx
    w = G.dequantize_int8(tq.qweight, tq.scales)
    mag = _np(xs.abs() @ w.abs()) + 1e-9

    def gap(y):
        return (np.abs(y - want) / mag).max()

    assert gap(got) < K7_TOL
    # the limit sees the mode: f32 operands, or an unrounded weight, fail it
    assert gap(_np(xs @ w)) > 10 * K7_TOL
    assert gap(_np(G._bf16_round(xs) @ w)) > 10 * K7_TOL


def test_apply_linear_routes():
    """A symmetric int8 weight with a norm takes K5's route (the normed x
    stays f32) up to 128 rows, and at 129 rows without mxu_bf16 the
    reference's dequantize-then-dot route (the norm first, rounded to the
    activation dtype); with mxu_bf16, 128 rows stay f32 and 129 rows take
    the bf16 operands (K7); an asymmetric weight norms first, rounds, and
    takes K4, or at 129 rows with mxu_bf16 K7 with its zero-point
    correction, and without it the dequantize-then-dot route."""
    rng = np.random.default_rng(300)
    tq = bridge.convert(_sym8(rng, 256, 128))
    ln = torch.from_numpy((rng.random(256) + 0.5).astype(np.float32))
    for n in (5, 128, 129):
        x = torch.from_numpy(rng.standard_normal((n, 256)).astype(np.float32))
        plain32 = G.int8_ln_matmul_plain(x, tq.qweight, tq.scales, ln, 1e-5)
        plain16 = G.int8_ln_matmul_plain(x, tq.qweight, tq.scales, ln, 1e-5,
                                         bf16_operands=True)
        routed = tlin.dequant_matmul(tlin.rms_norm(x, ln, 1e-5), tq)
        assert torch.equal(tlin.apply_linear(tq, x, norm=(ln, 1e-5)),
                           routed if n == 129 else plain32), n
        got = tlin.apply_linear(tq, x, norm=(ln, 1e-5), mxu_bf16=True)
        assert torch.equal(got, plain16 if n == 129 else plain32), n
        got = tlin.apply_linear(tq, x, mxu_bf16=True)
        want = G.int8_matmul_plain(x, tq.qweight, tq.scales,
                                   bf16_operands=n == 129)
        assert torch.equal(got, want), n
        got = tlin.apply_linear(tq, x)
        want = (tlin.dequant_matmul(x, tq) if n == 129 else
                G.int8_matmul_plain(x, tq.qweight, tq.scales))
        assert torch.equal(got, want), n
    assert not torch.equal(plain16, plain32)
    # in bf16 the 129-row route rounds the normed x and the weight, where
    # K5's fused route did not
    xb = x.to(torch.bfloat16)
    got = tlin.apply_linear(tq, xb, norm=(ln, 1e-5))
    assert torch.equal(got, tlin.dequant_matmul(tlin.rms_norm(xb, ln, 1e-5),
                                                tq))
    assert not torch.equal(got, G.int8_ln_matmul_plain(xb, tq.qweight,
                                                       tq.scales, ln, 1e-5))
    asym = tlin.quantize(torch.randn(256, 128), bits=8)
    x = torch.randn(129, 256)
    xn = tlin.rms_norm(x, ln, 1e-5)
    want = G.int8_matmul_plain(xn, asym.qweight, asym.scales, asym.zeros,
                               bf16_operands=True)
    assert torch.equal(tlin.apply_linear(asym, x, norm=(ln, 1e-5),
                                         mxu_bf16=True), want)
    assert torch.equal(tlin.apply_linear(asym, x, norm=(ln, 1e-5)),
                       tlin.dequant_matmul(xn, asym))
    assert torch.equal(tlin.apply_linear(asym, x[:128], norm=(ln, 1e-5)),
                       G.int8_matmul_plain(xn[:128], asym.qweight,
                                           asym.scales, asym.zeros))


def test_apply_linear_int8_norm_matches_pallas_route():
    """apply_linear's fused int8 norm equals the JAX Pallas route's
    (gptq_path='pallas'), which norms inside the kernel."""
    rng = np.random.default_rng(310)
    jq = _sym8(rng, 256, 256)
    x = rng.standard_normal((2, 7, 256)).astype(np.float32)
    ln = (rng.random(256) + 0.5).astype(np.float32)
    want = np.asarray(jlin.apply_linear(jq, jnp.asarray(x), path="pallas",
                                        rms=(jnp.asarray(ln), 1e-5)))
    got = tlin.apply_linear(bridge.convert(jq), torch.from_numpy(x),
                            norm=(torch.from_numpy(ln), 1e-5))
    np.testing.assert_allclose(_np(got), want, rtol=3e-4, atol=3e-4)


def _rand_cache(rng, L=2, B=3, S=20, H=2, D=4):
    k = rng.standard_normal((L, B, S, H, D)).astype(np.float32)
    v = rng.standard_normal((L, B, S, H, D)).astype(np.float32)
    return k, v


def _jcache(k, v, length=0):
    return jkv.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                       length=jnp.int32(length),
                       start=jnp.zeros((k.shape[1],), jnp.int32))


def _tcache(k, v, length=0):
    return tkv.KVCache(k=torch.from_numpy(k.copy()),
                       v=torch.from_numpy(v.copy()), length=length,
                       start=torch.zeros(k.shape[1], dtype=torch.int64))


def test_compact_path_exact():
    rng = np.random.default_rng(401)
    k, v = _rand_cache(rng)
    rel = np.array([0, 3, 5, -1, -1], np.int32)
    jc = jkv.compact_path(_jcache(k, v, 9), jnp.asarray(rel), jnp.int32(3),
                          jnp.int32(9))
    tc = tkv.compact_path(_tcache(k, v, 9), torch.from_numpy(rel).long(), 3, 9)
    assert tc.length == int(jc.length) == 12
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))


def test_compact_path_staged_exact():
    """Staging region [14, 20); a destination reaching it is dropped."""
    rng = np.random.default_rng(403)
    k, v = _rand_cache(rng)
    rel = np.array([[0, 2, 4, -1], [0, 1, -1, -1], [0, 3, 5, 1]], np.int32)
    nv = np.array([3, 2, 4], np.int32)
    dst = np.array([4, 0, 12], np.int32)
    jc = jkv.compact_path_staged(_jcache(k, v), jnp.asarray(rel),
                                 jnp.asarray(nv), jnp.asarray(dst),
                                 src_base=14)
    tc = tkv.compact_path_staged(_tcache(k, v), torch.from_numpy(rel).long(),
                                 torch.from_numpy(nv).long(),
                                 torch.from_numpy(dst).long(), src_base=14)
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))


def _tcfg(jcfg):
    return TCfg(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "head_dim", "rope_theta",
        "rope_scaling", "rms_norm_eps", "tie_word_embeddings",
        "attention_bias", "eos_token_id")}, dtype=torch.float32)


def _int8_params(jcfg):
    p = jtr.fuse_params(jcfg, jtr.init_params(jcfg, jax.random.PRNGKey(3)))
    layers = dict(p.layers)
    for name in ("wqkv", "wo", "wgu", "wdown"):
        layers[name] = jax.vmap(lambda w: jlin.quantize(
            w, bits=8, group_size=128, symmetric=True))(layers[name])
    return p._replace(layers=layers, lm_head=jlin.quantize(
        p.lm_head, bits=8, group_size=128, symmetric=True))


MODELS = {
    "dense": (JCfg.tiny(), lambda c: jtr.init_params(c, jax.random.PRNGKey(0))),
    "int8": (JCfg(vocab_size=256, hidden_size=256, intermediate_size=512,
                  num_layers=2, num_heads=4, num_kv_heads=2,
                  tie_word_embeddings=False, attention_bias=False,
                  dtype=jnp.float32, gptq_path="pallas"), _int8_params),
}


@pytest.mark.parametrize("model", ["dense", "int8"])
def test_forward_hooks_parity(model):
    """Two staged tree forwards (per-row lengths + per-row bias + explicit
    positions), the first with layer-input features, the second with the
    final hidden as the feature stream, each against the JAX forward on the
    same cache."""
    jcfg, make = MODELS[model]
    jp = make(jcfg)
    tcfg, tp = _tcfg(jcfg), bridge.params_from_jax(jp)
    rng = np.random.default_rng(500)
    B, T, S = 2, 6, 32
    jc = jkv.init_cache(jcfg, B, S)
    k0 = rng.standard_normal(jc.k.shape).astype(np.float32)
    v0 = rng.standard_normal(jc.v.shape).astype(np.float32)
    start = np.array([1, 0], np.int32)
    jc = jc._replace(k=jnp.asarray(k0), v=jnp.asarray(v0),
                     start=jnp.asarray(start))
    tc = tkv.KVCache(k=torch.from_numpy(k0.copy()),
                     v=torch.from_numpy(v0.copy()), length=0,
                     start=torch.from_numpy(start).long())
    toks = rng.integers(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    lengths = np.array([5, 9], np.int32)
    pos = (lengths[:, None] - start[:, None]
           + rng.integers(0, 3, size=(B, T))).astype(np.int32)
    bias = np.where(rng.random((B, T, T)) < 0.4, -1e30, 0.0).astype(np.float32)
    for b in range(B):
        np.fill_diagonal(bias[b], 0.0)

    for feats_at, staging in (((0, 1), 24), ((-1,), 24)):
        fwd = jax.jit(functools.partial(jtr.forward, jcfg,
                                        feature_layers=feats_at,
                                        staging_at=staging))
        jl, jc, jf = fwd(jp, jnp.asarray(toks), jc, attn_bias=jnp.asarray(bias),
                         positions=jnp.asarray(pos),
                         lengths=jnp.asarray(lengths))
        tl, tc, tf = ttr.forward(tcfg, tp, torch.from_numpy(toks).long(), tc,
                                 attn_bias=torch.from_numpy(bias),
                                 positions=torch.from_numpy(pos).long(),
                                 feature_layers=feats_at,
                                 lengths=torch.from_numpy(lengths).long(),
                                 staging_at=staging)
        ctx = f"{model} features {feats_at} staging {staging}"
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL,
                                   err_msg=ctx)
        # the random residual stream grows to an RMS of ~2e3, where f32
        # summation order alone moves elements by ~1e-2: compare the
        # features in units of their row RMS (what the head's norm sees)
        jf = np.asarray(jf)
        rms = np.sqrt(np.mean(jf ** 2, axis=-1, keepdims=True))
        np.testing.assert_allclose(_np(tf) / rms, jf / rms, **TOL,
                                   err_msg=ctx)
        np.testing.assert_allclose(_np(tc.k), np.asarray(jc.k), **TOL,
                                   err_msg=ctx)
        np.testing.assert_allclose(_np(tc.v), np.asarray(jc.v), **TOL,
                                   err_msg=ctx)
        assert tc.length == int(jc.length)
        lengths = lengths + 2


def test_forward_lengths_need_staging():
    """Per-row lengths with the per-row tree bias come with the staged tree
    block only: the unstaged ragged append (the speculative slot pool's,
    tests/test_torch_ragged.py) takes no bias; staging needs the lengths."""
    jcfg, make = MODELS["dense"]
    tcfg, tp = _tcfg(jcfg), bridge.params_from_jax(make(jcfg))
    tc = tkv.init_cache(tcfg, 2, 16, "cpu")
    toks = torch.zeros((2, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="takes no attn_bias"):
        ttr.forward(tcfg, tp, toks, tc, attn_bias=torch.zeros((2, 3, 3)),
                    lengths=torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="needs per-row lengths"):
        ttr.forward(tcfg, tp, toks, tc, attn_bias=torch.zeros((2, 3, 3)),
                    staging_at=12)


@pytest.mark.parametrize("model", ["dense", "int8"])
def test_last_only_head_parity(model):
    """A prefill with last_only: the last position's logits equal the JAX
    forward's (which computes every position's), with the same cache and
    feature stream."""
    jcfg, make = MODELS[model]
    jp = make(jcfg)
    tcfg, tp = _tcfg(jcfg), bridge.params_from_jax(jp)
    toks = np.random.default_rng(510).integers(
        0, jcfg.vocab_size, size=(2, 9)).astype(np.int32)
    jl, jc, jf = jtr.forward(jcfg, jp, jnp.asarray(toks),
                             jkv.init_cache(jcfg, 2, 16),
                             feature_layers=(-1,))
    tl, tc, tf = ttr.forward(tcfg, tp, torch.from_numpy(toks).long(),
                             tkv.init_cache(tcfg, 2, 16, "cpu"),
                             feature_layers=(-1,), last_only=True)
    assert tl.shape == (2, 1, jcfg.vocab_size)
    np.testing.assert_allclose(_np(tl), np.asarray(jl)[:, -1:], **TOL)
    np.testing.assert_allclose(_np(tc.k), np.asarray(jc.k), **TOL)
    assert tf.shape == np.asarray(jf).shape and tc.length == 9
