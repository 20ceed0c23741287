"""K7's and K7i4's norm-fused plain forms against the Pallas kernels' bf16
mode (`gptq_matmul(..., ln=, interpret=True, mxu_bf16=True)`) over more
sizes and seeds than `test_k7_split_matches_pallas`, in its manner:

* the product on the reference's inverse RMS within `K7_TOL` of
  sum |x * w| per output: the port's plain form there, on the f32 normed
  rows, which it rounds to bf16 (K7i4: with the group sums of the
  unrounded rows in its correction). The reference's inverse RMS is taken
  as `_kernel_ln` / `_kernel_int4_ln` compute it, by their ops inside an
  interpret-mode `pallas_call` on the padded rows: the same ops outside a
  kernel differ from it by a few ulps in some rows (XLA orders the mean's
  sum by context), which flips a normed value's rounding now and then;
* the port's inverse RMS within 2^-21 of the reference's: the two sum
  mean(x^2) in different orders, so about half the rows differ in the last
  bit or two;
* the port's normed rows xn (the pre-pass's `k7_stage_plain`) within one
  bf16 step of the reference's, and off it at no more than 1e-4 of the
  values: those that lie on a rounding boundary, where the inverse RMS's
  last bits decide;
* a negative control: the unrounded normed x fails the limit tenfold.

The fused plain form on the port's own inverse RMS differs from the
reference by up to ~1e-4 of sum |x * w| where such a flip lands; this
holds the arithmetic to `K7_TOL` apart from those flips and bounds the
flips themselves.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental import pallas as pl

from hsd_tpu.ops import gptq_pallas as jgp
from hsd_tpu.ops import linear as jlin
from hsd_tpu_torch import bridge
from hsd_tpu_torch.ops import gptq_cuda as G

torch.set_num_threads(2)
K7_TOL = 1e-5          # test_torch_eagle_ops.K7_TOL
EPS = 1e-5
# (rows, din, group size); each at three seeds
SIZES = [(130, 384, 64), (257, 768, 128), (480, 2048, 128),
         (700, 1024, 128)]
CASES = [(n, din, gs, seed) for n, din, gs in SIZES for seed in (0, 1, 2)]


def _weight(rng, packed, din, dout, gs):
    """A symmetric JAX QuantizedLinear of random codes, bf16 scales."""
    if packed:
        codes = rng.integers(0, 256, size=(din // 2, dout)).astype(np.uint8)
    else:
        codes = rng.integers(-127, 128, size=(din, dout)).astype(np.int8)
    scales = (np.abs(rng.standard_normal((din // gs, dout))) * 1e-2
              + 1e-3).astype(np.float32)
    return jlin.QuantizedLinear(qweight=jnp.asarray(codes),
                                scales=jnp.asarray(scales).astype(
                                    jnp.bfloat16), zeros=None)


def _kernel_inv_rms(xj):
    """rsqrt(mean(x^2) + eps) per row by the Pallas kernels' ops, inside an
    interpret-mode pallas_call on the rows padded as gptq_matmul pads them
    (`_kernel_ln`, gptq_pallas.py:104; `_kernel_int4_ln`, :203)."""
    n = xj.shape[0]
    npad = max(8, -(-n // 8) * 8)
    xp = jnp.zeros((npad, xj.shape[1]), jnp.float32).at[:n].set(xj)

    def kern(x_ref, o_ref):
        xf = x_ref[:]
        o_ref[:] = jax.lax.rsqrt(jnp.mean(xf * xf, axis=1, keepdims=True)
                                 + EPS)
    out = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct(
        (npad, 1), jnp.float32), interpret=True)(xp)
    return torch.from_numpy(np.array(out[:n]))


@pytest.mark.parametrize("kernel", ["K7", "K7i4"])
@pytest.mark.parametrize("n,din,gs,seed", CASES)
def test_fused_plain_matches_pallas(kernel, n, din, gs, seed):
    packed = kernel == "K7i4"
    rng = np.random.default_rng(1000 * seed + n + din + packed)
    jq = _weight(rng, packed, din, 256, gs)
    tq = bridge.convert(jq)
    x = rng.standard_normal((n, din)).astype(np.float32)
    ln = (rng.random(din) + 0.5).astype(np.float32)
    xj = jnp.asarray(x)
    want = np.asarray(jgp.gptq_matmul(xj, jq, ln=jnp.asarray(ln), ln_eps=EPS,
                                      interpret=True, mxu_bf16=True))
    xf, lnt = torch.from_numpy(x), torch.from_numpy(ln)
    ref_inv = _kernel_inv_rms(xj)
    if packed:
        inv, xn, xg = G.k7_stage_plain(xf, lnt, EPS, groups=din // gs)
    else:
        inv, xn = G.k7_stage_plain(xf, lnt, EPS)
    assert ((inv - ref_inv[:, 0]).abs() <= 2.0 ** -21 * ref_inv[:, 0]).all()
    ref_xs = (xf * ref_inv) * lnt
    ref_xn = ref_xs.to(torch.bfloat16)
    diff = (xn.float() - ref_xn.float()).abs()
    step = 2.0 ** (torch.floor(torch.log2(ref_xn.float().abs())) - 7)
    assert (diff <= step).all()
    assert (diff > 0).sum().item() <= 1e-4 * n * din
    # the fused plain form on the reference's normed rows
    plain = G.int4_matmul_plain if packed else G.int8_matmul_plain
    got = plain(ref_xs, tq.qweight, tq.scales, bf16_operands=True).numpy()
    w = (G.dequantize_int4 if packed else G.dequantize_int8)(tq.qweight,
                                                              tq.scales)
    mag = (ref_xs.abs() @ w.abs()).numpy() + 1e-9
    assert (np.abs(got - want) / mag).max() < K7_TOL
    # the limit sees the rounding of xn: the unrounded normed x fails it
    unrounded = (ref_xs @ G._bf16_round(w)).numpy()
    assert (np.abs(unrounded - want) / mag).max() > 10 * K7_TOL
