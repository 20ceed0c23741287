"""The per-row ragged cache append and `forward(lengths=...)` without
staging (the speculative slot pool's path), against the JAX package on the
CPU; and the pool's product routes, decided on one slot's rows.

* `append_layer_stacked_ragged` against JAX's on the same numpy buffers:
  equal bit for bit (a copy).
* `transformer.forward(..., lengths=...)` on a cache whose rows sit at
  different frontiers (and different left pads), against JAX's forward with
  `lengths` (ModelConfig.tiny, float32): logits and the whole cache within
  1e-5 of each tensor's scale, max(1, max |JAX's value|) (the new keys
  reach ~23 here, and f32 summation order moves them by up to ~1e-6 of
  that), the returned length cache.length + T on both sides.
* The route pin: the JAX server vmaps its per-slot forward, so a product's
  gate (`_use_pallas`, the K2 / K6 fusion gates) counts ONE slot's rows;
  the port's pool stacks every slot's rows into one call and passes
  `slots`, so its gates count the same rows. Held at more than 128
  flattened rows: JAX's decision under vmap (recorded with the backend
  reported as "tpu") against the port's route (recorded at its wrappers),
  and the fusion gates against `attn_mlp_fusion_supported` /
  `mlp_fusion_supported` on one slot's shape.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.engine.kvcache import KVCache as JKV
from hsd_tpu.engine.kvcache import append_layer_stacked_ragged as j_append
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu.models import transformer as jtr
from hsd_tpu.ops import gptq_pallas as jgp
from hsd_tpu.ops import linear as jlin
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import ModelConfig as TCfg
from hsd_tpu_torch.engine.kvcache import (KVCache,
                                          append_layer_stacked_ragged,
                                          init_cache)
from hsd_tpu_torch.models import transformer as ttr
from hsd_tpu_torch.ops import gptq_cuda as G
from hsd_tpu_torch.ops import linear as tlin

torch.set_num_threads(2)


def _close(got, want, tol=1e-5):
    """max |got - want| within tol of the tensor's scale, max(1, max
    |want|)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(np.asarray(got) - want).max() <= tol * scale


def _tcfg(jcfg):
    return TCfg(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "head_dim", "rope_theta",
        "rope_scaling", "rms_norm_eps", "tie_word_embeddings",
        "attention_bias", "eos_token_id")}, dtype=torch.float32)


@pytest.mark.parametrize("T", [1, 3])
def test_ragged_append_matches_jax(T):
    rng = np.random.default_rng(T)
    L, B, S, H, D = 3, 4, 16, 2, 8
    k_all = rng.standard_normal((L, B, S, H, D)).astype(np.float32)
    v_all = rng.standard_normal((L, B, S, H, D)).astype(np.float32)
    k_new = rng.standard_normal((B, T, H, D)).astype(np.float32)
    v_new = rng.standard_normal((B, T, H, D)).astype(np.float32)
    lengths = np.array([0, 5, 9, S - T], np.int32)
    jk, jv = j_append(jnp.asarray(k_all), jnp.asarray(v_all), jnp.int32(1),
                      jnp.asarray(lengths), jnp.asarray(k_new),
                      jnp.asarray(v_new))
    tk, tv = torch.from_numpy(k_all.copy()), torch.from_numpy(v_all.copy())
    out = append_layer_stacked_ragged(tk, tv, 1,
                                      torch.from_numpy(lengths).long(),
                                      torch.from_numpy(k_new),
                                      torch.from_numpy(v_new))
    assert out[0] is tk and out[1] is tv          # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # rows past the written positions and the other layers are untouched
    np.testing.assert_array_equal(tk.numpy()[0], k_all[0])


@pytest.mark.parametrize("T", [1, 2, 6])
def test_forward_ragged_lengths_matches_jax(T):
    jcfg = dataclasses.replace(JCfg.tiny(vocab_size=64), dtype=jnp.float32)
    jp = j_init_params(jcfg, jax.random.PRNGKey(4))
    tcfg, tp = _tcfg(jcfg), bridge.params_from_jax(jp)
    rng = np.random.default_rng(10 + T)
    B, S = 4, 24
    shape = (jcfg.num_layers, B, S, jcfg.num_kv_heads, jcfg.head_dim_)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    start = np.array([0, 3, 1, 5], np.int32)
    lengths = np.array([6, 11, 2, S - T], np.int32)   # divergent frontiers
    toks = rng.integers(0, 64, (B, T)).astype(np.int32)
    jc = JKV(k=jnp.asarray(k), v=jnp.asarray(v), length=jnp.int32(7),
             start=jnp.asarray(start))
    jl, jc2 = jtr.forward(jcfg, jp, jnp.asarray(toks), jc,
                          lengths=jnp.asarray(lengths))
    tc = KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()),
                 length=7, start=torch.from_numpy(start).long())
    tl, tc2 = ttr.forward(tcfg, tp, torch.from_numpy(toks).long(), tc,
                          lengths=torch.from_numpy(lengths).long())
    _close(tl.numpy(), jl)
    _close(tc2.k.numpy(), jc2.k)
    _close(tc2.v.numpy(), jc2.v)
    assert tc2.length == int(jc2.length) == 7 + T
    # each row's queries sit at its own frontier: row b's logits equal a
    # one-row uniform forward at cache.length = lengths[b]
    for b in range(B):
        one = KVCache(k=torch.from_numpy(k[:, b:b + 1].copy()),
                      v=torch.from_numpy(v[:, b:b + 1].copy()),
                      length=int(lengths[b]),
                      start=torch.from_numpy(start[b:b + 1]).long())
        lb, _ = ttr.forward(tcfg, tp, torch.from_numpy(toks[b:b + 1]).long(),
                            one)
        _close(lb.numpy()[0], tl.numpy()[b])


def _int8_weight(din=256, dout=384, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((din, dout)).astype(np.float32)
    jq = jlin.quantize(jnp.asarray(w), bits=8, group_size=128,
                       symmetric=False)
    return jq, bridge.convert(jq)


def _record_port(monkeypatch):
    """Record the port's route per apply_linear call: 'kernel' where a
    kernel wrapper runs (its plain version on the CPU), 'xla' where
    xla_matmul does."""
    seen = []
    for name in ("int8_matmul", "int8_ln_matmul", "int4_matmul",
                 "int4_ln_matmul"):
        real = getattr(G, name)

        def rec(*a, _real=real, **k):
            seen.append(("kernel", a[0].shape[0]))
            return _real(*a, **k)
        monkeypatch.setattr(tlin.gptq_cuda, name, rec)
    real_xla = tlin.xla_matmul

    def rec_xla(x, w):
        seen.append(("xla", x.shape[0]))
        return real_xla(x, w)
    monkeypatch.setattr(tlin, "xla_matmul", rec_xla)
    return seen


@pytest.mark.parametrize("slots,rows", [(8, 24), (16, 11), (2, 130),
                                        (3, 128)])
def test_slot_batched_product_routes_as_one_slot(slots, rows, monkeypatch):
    """More than 128 flattened rows: JAX's vmapped per-slot call decides on
    one slot's rows; so does the port's stacked call with `slots`."""
    jq, tq = _int8_weight(seed=rows)
    rng = np.random.default_rng(slots)
    x = rng.standard_normal((slots, rows, tq.din)).astype(np.float32)
    assert slots * rows > 128
    decisions = []
    real_use = jlin._use_pallas

    def rec_use(xx, w, path=None, mxu_bf16=False):
        with monkeypatch.context() as m:
            m.setattr(jax, "default_backend", lambda: "tpu")
            decisions.append((math.prod(xx.shape[:-1]),
                              real_use(xx, w, "auto", mxu_bf16)))
        return False          # run the XLA route here: no Pallas on the CPU
    monkeypatch.setattr(jlin, "_use_pallas", rec_use)
    want = np.asarray(jax.vmap(lambda xs: jlin.apply_linear(jq, xs))(
        jnp.asarray(x)))
    assert decisions == [(rows, rows <= 128)]        # one slot's rows
    seen = _record_port(monkeypatch)
    got = tlin.apply_linear(tq, torch.from_numpy(x).reshape(-1, tq.din),
                            slots=slots)
    assert seen == [("kernel" if rows <= 128 else "xla", slots * rows)]
    w = tlin.dequantize(tq, torch.float32).numpy()
    mag = np.abs(x.reshape(-1, tq.din)) @ np.abs(w) + 1e-9
    err = np.abs(got.numpy() - want.reshape(-1, w.shape[1])) / mag
    assert err.max() < 1e-6
    # without the slot count the stacked call would cross into route A
    seen.clear()
    tlin.apply_linear(tq, torch.from_numpy(x).reshape(-1, tq.din))
    assert seen == [("xla", slots * rows)]


def test_route_rows_needs_whole_slots():
    assert tlin.route_rows(88, 8) == 11
    with pytest.raises(ValueError):
        tlin.route_rows(89, 8)


@pytest.mark.parametrize("n", [1, 11, 32, 33])
def test_fusion_gates_count_one_slot(n):
    """K2 / K6 at the 14B widths: the stacked pool call with `slots` fuses
    exactly where one slot's rows fuse in the JAX gate (<= 32 rows), though
    8 slots' rows are 8 to 264."""
    D, F, Dh, gs, L, slots = 5120, 13824, 5120, 128, 2, 8

    def pair(din, dout):
        j = jlin.QuantizedLinear(
            qweight=jax.ShapeDtypeStruct((L, din // 2, dout), jnp.uint8),
            scales=jax.ShapeDtypeStruct((L, din // gs, dout), jnp.bfloat16),
            zeros=None)
        t = tlin.QuantizedLinear(
            qweight=torch.empty((L, din // 2, dout), dtype=torch.uint8,
                                device="meta"),
            scales=torch.empty((L, din // gs, dout), dtype=torch.bfloat16,
                               device="meta"),
            zeros=None)
        return j, t
    (jwo, two), (jgu, tgu), (jdn, tdn) = pair(Dh, D), pair(D, 2 * F), \
        pair(F, D)
    k2 = jgp.attn_mlp_fusion_supported(
        jax.ShapeDtypeStruct((n, Dh), jnp.bfloat16), jwo, jgu, jdn)
    k6 = jgp.mlp_fusion_supported(
        jax.ShapeDtypeStruct((n, D), jnp.bfloat16), jgu, jdn)
    assert k2 == k6 == (n <= 32)
    att = torch.empty((slots * n, Dh), dtype=torch.bfloat16, device="meta")
    x = torch.empty((slots * n, D), dtype=torch.bfloat16, device="meta")
    assert tlin.attn_mlp_fusable(att, two, tgu, tdn, layer=0,
                                 slots=slots) == k2
    assert tlin.mlp_fusable(x, tgu, tdn, layer=0, slots=slots) == k6
    # counted over the flattened rows instead, 8 slots fuse only at n = 1
    assert tlin.attn_mlp_fusable(att, two, tgu, tdn, layer=0) == (
        slots * n <= 32)


def test_pool_forward_stays_on_kernels(monkeypatch):
    """A slot-batched forward of an int8 model over 8 slots x 11 rows x 2
    tokens (176 rows): every product, the head's included, runs its kernel
    at 176 rows, none takes route A."""
    from hsd_tpu_torch.eval.synthetic import quantize_draft
    cfg = TCfg.tiny(vocab_size=256, hidden_size=256, intermediate_size=512,
                    num_heads=4, num_kv_heads=2, dtype=torch.float32)
    small = ttr.fuse_params(cfg, ttr.init_params(cfg, seed=0, device="cpu"))
    draft = quantize_draft(cfg, small, bits=8)
    slots, R, T, S = 8, 11, 2, 16
    cache = init_cache(cfg, slots * R, S, "cpu")
    lengths = torch.arange(slots * R) % 7
    toks = torch.randint(0, 256, (slots * R, T),
                         generator=torch.Generator().manual_seed(0))
    seen = _record_port(monkeypatch)
    ttr.forward(cfg, draft, toks, cache, lengths=lengths, slots=slots)
    assert seen and all(r == ("kernel", slots * R * T) for r in seen), seen
    seen.clear()
    ttr.forward(cfg, draft, toks, init_cache(cfg, slots * R, S, "cpu"),
                lengths=lengths)
    assert all(kind == "xla" for kind, _ in seen)
