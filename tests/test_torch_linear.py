"""Port parity of ops/linear.py and the plain versions of the GPTQ kernels
(ops/gptq_cuda.py) against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both sides. The JAX
kernels run in Pallas interpret mode, as tests/test_gptq.py runs them.
Tolerances: integer layouts bit-exact; float32 kernels rtol = atol = 3e-4
(tests/test_gptq.py's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.ops import gptq_pallas as jgp
from hsd_tpu.ops import linear as jlin
from hsd_tpu_torch import bridge
from hsd_tpu_torch.ops import launch_counts
from hsd_tpu_torch.ops import gptq_cuda as G
from hsd_tpu_torch.ops import linear as tlin

torch.set_num_threads(2)
TOL = dict(rtol=3e-4, atol=3e-4)


def _np(t):
    return t.detach().cpu().float().numpy()


def _w(rng, din, dout):
    return (rng.standard_normal((din, dout)) * din ** -0.5).astype(np.float32)


def _jq(w, bits, symmetric, gs=128):
    return jlin.quantize(jnp.asarray(w), bits=bits, group_size=gs,
                         symmetric=symmetric)


def test_pack_unpack_bit_exact():
    rng = np.random.default_rng(0)
    codes = rng.integers(-8, 8, size=(256, 96)).astype(np.int8)
    jp = np.asarray(jlin.pack_int4(jnp.asarray(codes)))
    tp = tlin.pack_int4(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(jp, tp)
    np.testing.assert_array_equal(tlin.unpack_int4(torch.from_numpy(tp)).numpy(),
                                  codes)
    np.testing.assert_array_equal(np.asarray(jlin.unpack_int4(jnp.asarray(jp))),
                                  tlin.unpack_int4(torch.from_numpy(jp.copy())).numpy())


@pytest.mark.parametrize("bits,symmetric", [(8, False), (8, True),
                                            (4, False), (4, True)])
def test_quantize_bit_exact(bits, symmetric):
    rng = np.random.default_rng(bits + int(symmetric))
    w = _w(rng, 256, 192)
    jq = _jq(w, bits, symmetric)
    tq = tlin.quantize(torch.from_numpy(w), bits=bits, group_size=128,
                       symmetric=symmetric)
    np.testing.assert_array_equal(np.asarray(jq.qweight), tq.qweight.numpy())
    np.testing.assert_array_equal(np.asarray(jq.scales), tq.scales.numpy())
    if symmetric:
        assert jq.zeros is None and tq.zeros is None
    else:
        np.testing.assert_array_equal(np.asarray(jq.zeros), tq.zeros.numpy())


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize(bits):
    rng = np.random.default_rng(7)
    jq = _jq(_w(rng, 256, 128), bits, symmetric=(bits == 4))
    want = np.asarray(jlin.dequantize(jq, jnp.float32))
    got = tlin.dequantize(bridge.convert(jq), torch.float32)
    np.testing.assert_allclose(_np(got), want, **TOL)


@pytest.mark.parametrize("n", [1, 8, 11])
def test_k1_plain_matches_pallas(n):
    """K1: rmsnorm(x, ln) @ deq(W), packed int4 symmetric (_kernel_int4_ln)."""
    rng = np.random.default_rng(10 + n)
    jq = _jq(_w(rng, 256, 384), 4, symmetric=True)
    x = rng.standard_normal((n, 256)).astype(np.float32)
    ln = (rng.random(256) + 0.5).astype(np.float32)
    want = np.asarray(jgp.gptq_matmul(jnp.asarray(x), jq, ln=jnp.asarray(ln),
                                      ln_eps=1e-5, interpret=True))
    tq = bridge.convert(jq)
    got = G.int4_ln_matmul(torch.from_numpy(x), tq.qweight, tq.scales,
                           torch.from_numpy(ln), 1e-5)
    np.testing.assert_allclose(_np(got), want, **TOL)


@pytest.mark.parametrize("n", [1, 11])
def test_k3_plain_matches_pallas(n):
    """K3: x @ deq(W), packed int4 (_kernel_int4 + the -8 correction)."""
    rng = np.random.default_rng(20 + n)
    jq = _jq(_w(rng, 512, 256), 4, symmetric=True)
    x = rng.standard_normal((n, 512)).astype(np.float32)
    want = np.asarray(jgp.gptq_matmul(jnp.asarray(x), jq, interpret=True))
    tq = bridge.convert(jq)
    got = G.int4_matmul(torch.from_numpy(x), tq.qweight, tq.scales)
    np.testing.assert_allclose(_np(got), want, **TOL)


@pytest.mark.parametrize("n", [1, 2, 11])
def test_k4_plain_matches_pallas(n):
    """K4: x @ ((code - zero) * scale), asymmetric int8 (_kernel + the
    zero-point correction)."""
    rng = np.random.default_rng(30 + n)
    jq = _jq(_w(rng, 256, 384), 8, symmetric=False)
    x = rng.standard_normal((n, 256)).astype(np.float32)
    want = np.asarray(jgp.gptq_matmul(jnp.asarray(x), jq, interpret=True))
    tq = bridge.convert(jq)
    got = G.int8_matmul(torch.from_numpy(x), tq.qweight, tq.scales, tq.zeros)
    np.testing.assert_allclose(_np(got), want, **TOL)


def _tail_weights(rng, D=256, Fi=512):
    wo = _jq(_w(rng, D, D), 4, True)
    wgu = _jq(_w(rng, D, 2 * Fi), 4, True)
    wdown = _jq(_w(rng, Fi, D), 4, True)
    return wo, wgu, wdown


@pytest.mark.parametrize("n", [1, 8])
def test_k2_plain_matches_pallas(n):
    """K2: the fused layer tail (_kernel_attn_mlp_int4), x' kept f32."""
    rng = np.random.default_rng(40 + n)
    wo, wgu, wdown = _tail_weights(rng)
    att = rng.standard_normal((n, 256)).astype(np.float32)
    res = rng.standard_normal((n, 256)).astype(np.float32)
    ln = (rng.random(256) + 0.5).astype(np.float32)
    assert jgp.attn_mlp_fusion_supported(jnp.asarray(att), wo, wgu, wdown)
    want = np.asarray(jgp.gptq_attn_mlp_int4(
        jnp.asarray(att), jnp.asarray(res), wo, wgu, wdown, jnp.asarray(ln),
        ln_eps=1e-5, interpret=True))
    to, tg, td = (bridge.convert(w) for w in (wo, wgu, wdown))
    got = G.attn_mlp_int4(torch.from_numpy(att), torch.from_numpy(res),
                          to.qweight, to.scales, tg.qweight, tg.scales,
                          td.qweight, td.scales, torch.from_numpy(ln), 1e-5)
    np.testing.assert_allclose(_np(got), want, **TOL)


@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
@pytest.mark.parametrize("with_rms", [False, True])
def test_apply_linear_matches_jax(kind, with_rms):
    rng = np.random.default_rng(50)
    w = _w(rng, 256, 256)
    jw = {"dense": jnp.asarray(w), "int8": _jq(w, 8, False),
          "int4": _jq(w, 4, True)}[kind]
    x = rng.standard_normal((3, 5, 256)).astype(np.float32)
    b = rng.standard_normal(256).astype(np.float32)
    ln = (rng.random(256) + 0.5).astype(np.float32)
    rms = (jnp.asarray(ln), 1e-6) if with_rms else None
    want = np.asarray(jlin.apply_linear(jw, jnp.asarray(x), jnp.asarray(b),
                                        rms=rms, path="xla"))
    got = tlin.apply_linear(bridge.convert(jw), torch.from_numpy(x),
                            torch.from_numpy(b),
                            norm=(torch.from_numpy(ln), 1e-6)
                            if with_rms else None)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), want, **TOL)


def test_apply_linear_stacked_perm():
    """desc_act perm gather on a layer-stacked weight, norm before gather."""
    rng = np.random.default_rng(60)
    layers = [_jq(_w(rng, 256, 128), 8, False) for _ in range(2)]
    perms = np.stack([rng.permutation(256) for _ in range(2)]).astype(np.int32)
    jw = jax.tree.map(lambda *a: jnp.stack(a), *layers)
    jw = jw._replace(perm=jnp.asarray(perms))
    x = rng.standard_normal((4, 256)).astype(np.float32)
    ln = (rng.random(256) + 0.5).astype(np.float32)
    tw = bridge.convert(jw)
    for layer in range(2):
        want = np.asarray(jlin.apply_linear(
            jw, jnp.asarray(x), layer=jnp.int32(layer), path="xla",
            rms=(jnp.asarray(ln), 1e-6)))
        got = tlin.apply_linear(tw, torch.from_numpy(x), layer=layer,
                                norm=(torch.from_numpy(ln), 1e-6))
        np.testing.assert_allclose(_np(got), want, **TOL)


def test_tail_gate_rows():
    """The fused tail takes <= 32 rows, as gptq_pallas's gate does."""
    rng = np.random.default_rng(70)
    wo, wgu, wdown = (bridge.convert(w) for w in _tail_weights(rng))
    assert tlin.attn_mlp_fusable(torch.zeros(4, 8, 256), wo, wgu, wdown)
    assert not tlin.attn_mlp_fusable(torch.zeros(3, 11, 256), wo, wgu, wdown)
    asym = tlin.quantize(torch.randn(256, 256), bits=4, symmetric=False)
    assert not tlin.attn_mlp_fusable(torch.zeros(1, 256), asym, wgu, wdown)
    assert not tlin.attn_mlp_fusable(torch.zeros(1, 128), wo, wgu, wdown)


def test_cpu_wrappers_do_not_count_launches():
    """The counters count kernel launches only: plain-version calls on the
    CPU leave them untouched."""
    before = launch_counts()
    rng = np.random.default_rng(80)
    tq = bridge.convert(_jq(_w(rng, 256, 128), 8, False))
    G.int8_matmul(torch.randn(2, 256), tq.qweight, tq.scales, tq.zeros)
    assert launch_counts() == before
