"""Port parity of models/transformer.forward and the KV cache against the JAX
package: prefill, decode and an 11-row verify forward, then a rollback and
another decode, with per-row left padding.

* ModelConfig.tiny (dense float32), weights carried over by the bridge.
* A 2-layer Qwen-like shape (D=256, F=512, 4 heads / 2 KV heads) with
  stacked asymmetric-int8 or symmetric packed-int4 projections, an int8
  embedding and an untied quantized head. The JAX side runs with
  gptq_path="pallas" (interpret mode), so at <= 32 rows its layer tail is
  the fused kernel whose f32 x' the port's K2 reproduces, and above 32 rows
  the unfused path.

Tolerance: float32 logits rtol = atol = 2e-3; caches at the same.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.engine.kvcache import init_cache as j_init_cache
from hsd_tpu.engine.kvcache import rollback as j_rollback
from hsd_tpu.models import transformer as jtr
from hsd_tpu.ops.linear import quantize as j_quantize
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import ModelConfig as TCfg
from hsd_tpu_torch.engine.kvcache import init_cache as t_init_cache
from hsd_tpu_torch.engine.kvcache import rollback as t_rollback
from hsd_tpu_torch.models import transformer as ttr

torch.set_num_threads(2)
TOL = dict(rtol=2e-3, atol=2e-3)
QWEN_LIKE = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
                 num_layers=2, num_heads=4, num_kv_heads=2,
                 tie_word_embeddings=False)


def _tcfg(jcfg):
    """The port's config for a JAX config (same fields, torch dtype)."""
    return TCfg(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "head_dim", "rope_theta",
        "rope_scaling", "rms_norm_eps", "tie_word_embeddings",
        "attention_bias", "eos_token_id")}, dtype=torch.float32)


def _quantized(jcfg, bits, symmetric):
    p = jtr.fuse_params(jcfg, jtr.init_params(jcfg, jax.random.PRNGKey(3)))
    layers = dict(p.layers)
    for name in ("wqkv", "wo", "wgu", "wdown"):
        layers[name] = jax.vmap(lambda w: j_quantize(
            w, bits=bits, group_size=128, symmetric=symmetric))(layers[name])
    embed = jtr.quantize_embedding(p.embed)
    head = j_quantize(p.lm_head, bits=bits, group_size=128,
                      symmetric=symmetric)
    return p._replace(layers=layers, embed=embed, lm_head=head)


def _run_steps(jcfg, jparams, prefill_len, seed=0):
    """Drive JAX and the port through the same schedule; compare each step."""
    tcfg = _tcfg(jcfg)
    tparams = bridge.params_from_jax(jparams)
    B, S = 2, prefill_len + 24
    start = np.array([3, 0], np.int32)
    rng = np.random.default_rng(seed)
    jfwd = jax.jit(functools.partial(jtr.forward, jcfg))
    jc = j_init_cache(jcfg, B, S)._replace(start=jnp.asarray(start))
    tc = t_init_cache(tcfg, B, S, "cpu").replace(
        start=torch.from_numpy(start).long())

    def step(jc, tc, T):
        toks = rng.integers(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
        jl, jc = jfwd(jparams, jnp.asarray(toks), jc)
        tl, tc = ttr.forward(tcfg, tparams, torch.from_numpy(toks).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert tc.length == int(jc.length)
        n = tc.length
        np.testing.assert_allclose(tc.k[:, :, :n].float().numpy(),
                                   np.asarray(jc.k[:, :, :n], np.float32),
                                   **TOL)
        np.testing.assert_allclose(tc.v[:, :, :n].float().numpy(),
                                   np.asarray(jc.v[:, :, :n], np.float32),
                                   **TOL)
        return jc, tc

    jc, tc = step(jc, tc, prefill_len)    # prefill
    jc, tc = step(jc, tc, 1)              # decode
    jc, tc = step(jc, tc, 11)             # verify forward
    back = tc.length - 7
    jc, tc = j_rollback(jc, jnp.int32(back)), t_rollback(tc, back)
    jc, tc = step(jc, tc, 1)              # decode after rollback


@pytest.mark.parametrize("prefill_len", [1, 9])
def test_tiny_dense_parity(prefill_len):
    jcfg = JCfg.tiny()
    _run_steps(jcfg, jtr.init_params(jcfg, jax.random.PRNGKey(0)),
               prefill_len)


def test_tiny_unfused_params_parity():
    """Unfused q/k/v and gate/up (before fuse_params) take the same path."""
    jcfg = JCfg.tiny(num_layers=1)
    _run_steps(jcfg, jtr.init_params(jcfg, jax.random.PRNGKey(1)), 5, seed=1)


def test_llama3_rope_scaling_parity():
    jcfg = JCfg.tiny(rope_scaling=(8.0, 1.0, 4.0, 16), attention_bias=False)
    p = jtr.fuse_params(jcfg, jtr.init_params(jcfg, jax.random.PRNGKey(2)))
    _run_steps(jcfg, p, 6, seed=2)


@pytest.mark.parametrize("bits,symmetric", [(8, False), (4, True)])
@pytest.mark.parametrize("prefill_len", [12, 40])
def test_quantized_qwen_like_parity(bits, symmetric, prefill_len):
    jcfg = JCfg(**QWEN_LIKE, dtype=jnp.float32, gptq_path="pallas")
    _run_steps(jcfg, _quantized(jcfg, bits, symmetric), prefill_len)


@pytest.mark.parametrize("quantized", [False, True])
def test_skip_head_parity(quantized):
    """A prefill with skip_head gives the JAX package's last-layer hidden
    state and cache, and never touches the head."""
    if quantized:
        jcfg = JCfg(**QWEN_LIKE, dtype=jnp.float32, gptq_path="pallas")
        jp = _quantized(jcfg, 4, True)
    else:
        jcfg = JCfg.tiny()
        jp = jtr.init_params(jcfg, jax.random.PRNGKey(5))
    tcfg = _tcfg(jcfg)
    tp = bridge.params_from_jax(jp)._replace(lm_head="no head")
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, size=(2, 40)).astype(np.int32)
    start = np.array([4, 0], np.int32)
    jc = j_init_cache(jcfg, 2, 48)._replace(start=jnp.asarray(start))
    tc = t_init_cache(tcfg, 2, 48, "cpu").replace(
        start=torch.from_numpy(start).long())
    jx, jc = jtr.forward(jcfg, jp, jnp.asarray(toks), jc, skip_head=True)
    tx, tc = ttr.forward(tcfg, tp, torch.from_numpy(toks).long(), tc,
                         skip_head=True)
    assert tx.shape == (2, 40, jcfg.hidden_size)
    # the random int4 residual stream grows to an RMS of ~2e3, where f32
    # summation order alone moves elements by ~1; the head sees the hidden
    # state divided by its row RMS, so compare it in those units
    jx = np.asarray(jx)
    rms = np.sqrt(np.mean(jx ** 2, axis=-1, keepdims=True))
    np.testing.assert_allclose(tx.float().numpy() / rms, jx / rms, **TOL)
    assert tc.length == int(jc.length) == 40
    np.testing.assert_allclose(tc.k[:, :, :40].float().numpy(),
                               np.asarray(jc.k[:, :, :40], np.float32), **TOL)


def test_attention_bias_parity():
    """Optional [T, T] additive bias on the keys written this call."""
    jcfg = JCfg.tiny()
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(4))
    tcfg, tp = _tcfg(jcfg), bridge.params_from_jax(jp)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, size=(1, 6)).astype(np.int32)
    bias = np.where(rng.random((6, 6)) < 0.3, -1e9, 0.0).astype(np.float32)
    np.fill_diagonal(bias, 0.0)
    jl, _ = jtr.forward(jcfg, jp, jnp.asarray(toks), j_init_cache(jcfg, 1, 8),
                        attn_bias=jnp.asarray(bias))
    tl, _ = ttr.forward(tcfg, tp, torch.from_numpy(toks).long(),
                        t_init_cache(tcfg, 1, 8, "cpu"),
                        attn_bias=torch.from_numpy(bias))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_bridge_cache_roundtrip():
    jcfg = JCfg.tiny()
    jc = j_init_cache(jcfg, 2, 8)
    jc = jc._replace(k=jax.random.normal(jax.random.PRNGKey(0), jc.k.shape),
                     length=jnp.int32(5), start=jnp.array([1, 0], jnp.int32))
    tc = bridge.cache_from_jax(jc)
    assert tc.length == 5 and tc.start.tolist() == [1, 0]
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))


def test_bf16_bridge_bit_exact():
    jw = jax.random.normal(jax.random.PRNGKey(1), (4, 8)).astype(jnp.bfloat16)
    tw = bridge.to_torch(jw)
    assert tw.dtype == torch.bfloat16
    np.testing.assert_array_equal(tw.float().numpy(),
                                  np.asarray(jw.astype(jnp.float32)))


def test_entry_points_raise_without_a_card():
    """Entry points default to the card and raise when it is absent."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.init_params(TCfg.tiny())
