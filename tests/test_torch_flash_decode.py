"""Port parity of the flash-decode attention (K8) against the JAX package.

* The plain version (`flash_core_plain`) against `_flash_core` in Pallas
  interpret mode on tests/test_flash_decode.py's cases: T, H/Hkv, d 64/128,
  kv_len, start, a tree bias, RoPE, and a fully masked row that gives
  zeros. float32, within 1e-5.
* The routes: `use_flash` / `use_fused_rope_attn` decide as the JAX gates
  do under each setting of the module attributes.
* `forward` logits with FUSED_ATTN / FLASH_DECODE = "always" against the
  JAX forward under the same setting (both modules patched), within 2e-3.
* Greedy make_generate streams under each mode equal the JAX streams.

Models have head_dim 64 and caches of at least 128 slots, so the gates
send their decode steps to the kernel.
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
from hsd_tpu.engine.kvcache import init_cache as j_init_cache
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu.models import transformer as jtr
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine import make_generate
from hsd_tpu_torch.engine.kvcache import init_cache
from hsd_tpu_torch.models import transformer as ttr
from hsd_tpu_torch.ops import flash_decode as tfd
from hsd_tpu_torch.ops import launch_counts

torch.set_num_threads(2)
TOL = dict(rtol=2e-3, atol=2e-3)
# head_dim 256 / 4 = 64
JCFG = JCfg.tiny(vocab_size=64, hidden_size=256, intermediate_size=256,
                 num_layers=2, num_heads=4, num_kv_heads=2)
MODES = {"fused": ("FUSED_ATTN", "always"), "flash": ("FLASH_DECODE", "always")}


def _tcfg(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "rms_norm_eps", "tie_word_embeddings",
        "attention_bias", "eos_token_id")}, dtype=torch.float32)


def _set_mode(monkeypatch, mode):
    attr, value = MODES[mode]
    monkeypatch.setattr(jfd, attr, value)
    monkeypatch.setattr(tfd, attr, value)


def _rope_tables(rng, T, d):
    """JAX's per-position (cos, sin) [T, d/2] and the port's side-by-side
    (cos2, sin2) [T, d] of the same angles."""
    ang = rng.standard_normal((T, d // 2)).astype(np.float32) * 3
    cos, sin = np.cos(ang), np.sin(ang)
    return ((jnp.asarray(cos), jnp.asarray(sin)),
            (torch.from_numpy(np.concatenate([cos, cos], -1)),
             torch.from_numpy(np.concatenate([-sin, sin], -1))))


@pytest.mark.parametrize("T,H,Hkv,d,S,kv_len,start", [
    (1, 8, 2, 64, 300, 200, 0),      # AR decode, ragged S vs block
    (11, 8, 2, 64, 256, 97, 3),      # spec-verify block, left-padded
    (4, 4, 4, 128, 640, 500, 0),     # MHA (rep=1)
    (6, 8, 2, 64, 200, 50, 0),       # tree-attention geometry
])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("rope", [False, True])
def test_plain_matches_pallas(T, H, Hkv, d, S, kv_len, start, bias, rope):
    rng = np.random.default_rng(T * 7 + d + int(bias) + 2 * int(rope))
    q = rng.standard_normal((T, H, d)).astype(np.float32)
    k = rng.standard_normal((S, Hkv, d)).astype(np.float32)
    v = rng.standard_normal((S, Hkv, d)).astype(np.float32)
    qi = (kv_len + np.arange(T)).astype(np.int32)
    ab = None
    if bias:       # a trie mask: node i attends to its ancestor chain
        anc = np.tril(rng.random((T, T)) < 0.6)
        np.fill_diagonal(anc, True)
        ab = np.where(anc, 0.0, -1e30).astype(np.float32)
    jrope, trope = _rope_tables(rng, T, d) if rope else (None, None)
    want = np.asarray(jfd._flash_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qi),
        jnp.int32(start), jnp.int32(kv_len),
        None if ab is None else jnp.asarray(ab), rope=jrope, block_s=128,
        interpret=True))
    got = tfd.flash_core_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(qi).long(), torch.tensor([start]), kv_len,
        None if ab is None else torch.from_numpy(ab), trope, block_s=128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the wrapper's CPU route is the plain version at the Pallas block size
    wrapped = tfd.flash_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(qi).long(), torch.tensor([start]), kv_len,
        None if ab is None else torch.from_numpy(ab), trope)
    np.testing.assert_allclose(wrapped.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fully_masked_row_gives_zeros():
    """q_index < start: no valid key. The kernel's plain version gives
    zeros, as the Pallas kernel does (the einsum path gives V's mean)."""
    T, H, Hkv, d, S, kv_len, start = 2, 4, 2, 64, 128, 40, 8
    rng = np.random.default_rng(3)
    q = rng.standard_normal((T, H, d)).astype(np.float32)
    k = rng.standard_normal((S, Hkv, d)).astype(np.float32)
    v = rng.standard_normal((S, Hkv, d)).astype(np.float32)
    qi = np.array([kv_len, start - 2], np.int32)
    want = np.asarray(jfd._flash_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qi),
        jnp.int32(start), jnp.int32(kv_len), None, block_s=64,
        interpret=True))
    got = tfd.flash_core_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(qi).long(), torch.tensor([start]), kv_len,
        block_s=64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1], 0.0)
    assert np.abs(got[0]).max() > 0.1


@pytest.mark.parametrize("flash,fused", [("auto", "auto"), ("always", "auto"),
                                         ("auto", "always"),
                                         ("always", "always"),
                                         ("never", "always")])
def test_route_gates_match_jax(monkeypatch, flash, fused):
    for mod in (jfd, tfd):
        monkeypatch.setattr(mod, "FLASH_DECODE", flash)
        monkeypatch.setattr(mod, "FUSED_ATTN", fused)
    for B, T, H, Hkv, d, S in [(1, 1, 14, 2, 64, 204), (1, 11, 40, 8, 128, 204),
                               (1, 60, 32, 8, 128, 189), (1, 16, 4, 2, 64, 128),
                               (1, 17, 4, 2, 64, 128), (1, 129, 4, 2, 64, 300),
                               (2, 1, 4, 2, 64, 300), (1, 1, 4, 2, 16, 300),
                               (1, 1, 4, 2, 64, 127)]:
        jq = jax.ShapeDtypeStruct((B, T, H, d), jnp.float32)
        jk = jax.ShapeDtypeStruct((B, S, Hkv, d), jnp.float32)
        tq = torch.empty((B, T, H, d), device="meta")
        tk = torch.empty((B, S, Hkv, d), device="meta")
        assert tfd.use_flash(tq, tk) == jfd.use_flash(jq, jk)
        assert (tfd.use_fused_rope_attn(B, T, d, S)
                == jfd.use_fused_rope_attn(B, T, d, S))


@pytest.fixture(scope="module")
def dense_pair():
    jd = j_init_params(JCFG, jax.random.PRNGKey(0))
    jt = j_init_params(JCFG, jax.random.PRNGKey(1))
    return jd, jt, bridge.params_from_jax(jd), bridge.params_from_jax(jt)


@pytest.mark.parametrize("mode", ["fused", "flash"])
def test_forward_logits_match_jax(monkeypatch, dense_pair, mode):
    """Prefill (einsum), then a decode step, an 11-row verify step and a
    6-row step with a tree bias, under the mode, on both sides."""
    _set_mode(monkeypatch, mode)
    _, jt, _, tt = dense_pair
    tcfg = _tcfg(JCFG)
    rng = np.random.default_rng(5)
    start = 2
    jc = j_init_cache(JCFG, 1, 160)._replace(start=jnp.asarray([start],
                                                               jnp.int32))
    tc = init_cache(tcfg, 1, 160, "cpu").replace(start=torch.tensor([start]))
    jfwd = jax.jit(functools.partial(jtr.forward, JCFG))
    before = launch_counts()
    calls = []
    plain = tfd.flash_core_plain
    monkeypatch.setattr(tfd, "flash_core_plain",
                        lambda *a, **k: calls.append(a[0].shape[0])
                        or plain(*a, **k))
    for T, with_bias in ((130, False), (1, False), (11, False), (6, True)):
        toks = rng.integers(0, JCFG.vocab_size, (1, T)).astype(np.int32)
        bias = None
        if with_bias:
            anc = np.tril(rng.random((T, T)) < 0.6)
            np.fill_diagonal(anc, True)
            bias = np.where(anc, 0.0, -1e30).astype(np.float32)
        jl, jc = jfwd(jt, jnp.asarray(toks), jc,
                      attn_bias=None if bias is None else jnp.asarray(bias))
        tl, tc = ttr.forward(tcfg, tt, torch.from_numpy(toks).long(), tc,
                             attn_bias=None if bias is None
                             else torch.from_numpy(bias))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # the kernel's route, per layer: the decode and verify steps in both
    # modes, the biased step only in the flash mode
    routed = [1, 1, 11, 11] + ([6, 6] if mode == "flash" else [])
    assert calls == routed, calls
    assert launch_counts() == before       # CPU tensors launch nothing


def _greedy(max_new=16):
    return (JEng(verifier=JVer(method="greedy", gamma=3),
                 max_new_tokens=max_new, temperature=0.0),
            EngineConfig(verifier=VerifierConfig(method="greedy", gamma=3),
                         max_new_tokens=max_new, temperature=0.0))


@pytest.mark.parametrize("mode", ["fused", "flash"])
def test_generate_greedy_stream_matches_jax(monkeypatch, dense_pair, mode):
    _set_mode(monkeypatch, mode)
    jd, jt, td, tt = dense_pair
    jeng, teng = _greedy()
    prompt = (np.arange(128) % 50 + 2).astype(np.int32)
    jres = j_make_generate(JCFG, JCFG, jeng)(
        jd, jt, jnp.asarray(prompt), jnp.int32(120), jax.random.PRNGKey(1))
    tcfg = _tcfg(JCFG)
    tres = make_generate(tcfg, tcfg, teng)(
        td, tt, torch.from_numpy(prompt).long(), 120, None)
    n = int(jres.length)
    assert tres.length == n and n > 128
    np.testing.assert_array_equal(tres.tokens[:n].numpy(),
                                  np.asarray(jres.tokens)[:n])
    assert tres.blocks == int(jres.blocks)
