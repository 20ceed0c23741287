"""The fused SwiGLU MLP (K6) and the fusion gates of K2 and K6, against the
JAX package.

* K6's plain version (`gptq_cuda.mlp_int4_plain`) against `gptq_mlp_int4`
  in Pallas interpret mode, within 3e-4 (tests/test_gptq.py's float32
  tolerance), and `apply_mlp` routed to it exactly where the JAX
  `apply_mlp` takes the fused kernel.
* Gate parity: `attn_mlp_fusable` / `mlp_fusable` decide as
  `attn_mlp_fusion_supported` / `mlp_fusion_supported` on a table of
  shapes: the 0.5B, 7B, 14B, 32B and 72B widths, the 3584/3648-row edge of
  one gu in-block, ragged groups, and row counts around 32. The gates read
  only shapes and dtypes, so the JAX weights are jax.ShapeDtypeStructs and
  the port's meta tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.ops import gptq_pallas as jgp
from hsd_tpu.ops import linear as jlin
from hsd_tpu_torch import bridge
from hsd_tpu_torch.ops import gptq_cuda as G
from hsd_tpu_torch.ops import linear as tlin

torch.set_num_threads(2)
TOL = dict(rtol=3e-4, atol=3e-4)


def _jq(rng, din, dout, layers=None):
    def one():
        w = (rng.standard_normal((din, dout)) * din ** -0.5).astype(np.float32)
        return jlin.quantize(jnp.asarray(w), bits=4, group_size=128,
                             symmetric=True)
    if layers is None:
        return one()
    return jax.tree.map(lambda *a: jnp.stack(a), *[one() for _ in range(layers)])


@pytest.mark.parametrize("n", [1, 8, 11])
def test_k6_plain_matches_pallas(n):
    rng = np.random.default_rng(60 + n)
    wgu, wdown = _jq(rng, 256, 1024), _jq(rng, 512, 256)
    x = rng.standard_normal((n, 256)).astype(np.float32)
    ln = (rng.random(256) + 0.5).astype(np.float32)
    assert jgp.mlp_fusion_supported(jnp.asarray(x), wgu, wdown)
    want = np.asarray(jgp.gptq_mlp_int4(jnp.asarray(x), wgu, wdown,
                                        jnp.asarray(ln), ln_eps=1e-5,
                                        interpret=True))
    tg, td = bridge.convert(wgu), bridge.convert(wdown)
    got = G.mlp_int4(torch.from_numpy(x), tg.qweight, tg.scales, td.qweight,
                     td.scales, torch.from_numpy(ln), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("rows", [(1,), (2, 5), (40,)])
def test_apply_mlp_routes_as_jax(monkeypatch, rows):
    """Stacked weights, a layer index: the port's apply_mlp matches the
    JAX one (path="pallas": the fused kernel at <= 32 rows, else two
    matmuls) and takes K6 exactly where the JAX gate fuses."""
    rng = np.random.default_rng(70 + len(rows))
    wgu, wdown = _jq(rng, 256, 1024, layers=2), _jq(rng, 512, 256, layers=2)
    x = rng.standard_normal((*rows, 256)).astype(np.float32)
    ln = (rng.random(256) + 0.5).astype(np.float32)
    calls = []
    plain = G.mlp_int4_plain
    monkeypatch.setattr(G, "mlp_int4_plain",
                        lambda *a: calls.append(1) or plain(*a))
    want = np.asarray(jlin.apply_mlp(wgu, wdown, jnp.asarray(x),
                                     jnp.asarray(ln), 1e-6,
                                     layer=jnp.int32(1), path="pallas"))
    got = tlin.apply_mlp(bridge.convert(wgu), bridge.convert(wdown),
                         torch.from_numpy(x), torch.from_numpy(ln), 1e-6,
                         layer=1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    fused = jgp.mlp_fusion_supported(jnp.asarray(x), wgu, wdown)
    assert fused == (np.prod(rows) <= 32)
    assert bool(calls) == fused


# (D, F, Dh = heads x head_dim, group size) of the table
WIDTHS = {
    "0.5B": (896, 4864, 896, 128),
    "7B": (3584, 18944, 3584, 128),
    "14B": (5120, 13824, 5120, 128),
    "32B": (5120, 27648, 5120, 128),
    "72B": (8192, 29568, 8192, 128),
    "edge 3584 rows": (7168, 14336, 7168, 128),
    "edge 3648 rows": (7296, 14592, 7296, 128),
    "ragged groups (96)": (768, 1536, 768, 96),
    "odd group count": (384, 1024, 384, 128),
    "wo 3840 rows": (5120, 13824, 7680, 128),
}


def _weights(D, F, Dh, gs, L=2):
    """(JAX, port) stacked packed-int4 symmetric wo, wgu, wdown shapes."""
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
    return pair(Dh, D), pair(D, 2 * F), pair(F, D)


@pytest.mark.parametrize("name", list(WIDTHS))
def test_fusion_gates_match_jax(name):
    D, F, Dh, gs = WIDTHS[name]
    (jwo, two), (jgu, tgu), (jdn, tdn) = _weights(D, F, Dh, gs)
    seen = set()
    for n in (1, 11, 32, 33):
        j_att = jax.ShapeDtypeStruct((n, Dh), jnp.bfloat16)
        j_x = jax.ShapeDtypeStruct((n, D), jnp.bfloat16)
        t_att = torch.empty((n, Dh), dtype=torch.bfloat16, device="meta")
        t_x = torch.empty((n, D), dtype=torch.bfloat16, device="meta")
        k2 = jgp.attn_mlp_fusion_supported(j_att, jwo, jgu, jdn)
        k6 = jgp.mlp_fusion_supported(j_x, jgu, jdn)
        assert tlin.attn_mlp_fusable(t_att, two, tgu, tdn, layer=0) == k2, \
            (name, n)
        assert tlin.mlp_fusable(t_x, tgu, tdn, layer=0) == k6, (name, n)
        seen.add((k2, k6))
    if name == "72B":
        # 4096 packed rows of wgu (and of wo): neither fuses at any rows
        assert seen == {(False, False)}
    if name in ("14B", "32B", "7B", "edge 3584 rows"):
        assert (True, True) in seen


class _Fused(Exception):
    pass


class _Unfused(Exception):
    pass


# (wgu stacked, wdown stacked, layer index) of the stacking rule
STACKINGS = [(True, True, 1), (True, True, None), (False, False, None),
             (False, False, 0), (True, False, 1), (False, True, None)]


@pytest.mark.parametrize("stacking", STACKINGS)
def test_fusion_routes_need_matching_layer_index(monkeypatch, stacking):
    """The JAX routes fuse only when the weights are all layer-stacked with
    a layer index or all 2-D without one (`stacked_ok`); so do the port's
    gates, and apply_mlp never hands a stacked weight to K6 unindexed."""
    gu_stacked, dn_stacked, layer = stacking

    def unstack(pair, stacked):
        j, t = pair
        if stacked:
            return j, t
        return (jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape[1:],
                                                            a.dtype), j),
                t.layer(0))
    wo, wgu, wdown = _weights(256, 512, 256, 128)
    (jwo, two), (jgu, tgu) = unstack(wo, gu_stacked), unstack(wgu, gu_stacked)
    jdn, tdn = unstack(wdown, dn_stacked)
    j_x = jax.ShapeDtypeStruct((1, 256), jnp.float32)
    t_x = torch.empty((1, 256), device="meta")
    jl = None if layer is None else jnp.int32(layer)
    assert tlin.attn_mlp_fusable(t_x, two, tgu, tdn, layer=layer) == \
        jlin.attn_mlp_fusable(j_x, jwo, jgu, jdn, path="pallas", layer=jl)

    def fused(*a, **k):
        raise _Fused

    def unfused(*a, **k):
        raise _Unfused
    monkeypatch.setattr(jgp, "gptq_mlp_int4", fused)
    monkeypatch.setattr(jlin, "apply_linear", unfused)
    with pytest.raises((_Fused, _Unfused)) as jax_route:
        jlin.apply_mlp(jgu, jdn, j_x, None, 1e-6, layer=jl, path="pallas")
    want = jax_route.type is _Fused
    assert tlin.mlp_fusable(t_x, tgu, tdn, layer=layer) == want
    assert want == (gu_stacked == dn_stacked
                    and (layer is not None) == gu_stacked)
