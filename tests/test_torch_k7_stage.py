"""K7's split form on the CPU: its pre-pass (`gptq_cuda.k7_stage_plain`,
which writes each row's inverse RMS and the normed bf16 rows xn once) and
the product on xn that the main kernel computes.

* Feeding xn to `int8_matmul_plain(bf16_operands=True)` gives
  `int8_ln_matmul_plain(bf16_operands=True)` bit for bit: the pre-pass
  rounds the normed x to bf16 exactly where the fused form's operand
  rounding does.
* The split form against the Pallas kernel's bf16 mode
  (`gptq_matmul(..., interpret=True, mxu_bf16=True)`) within
  `test_k7_plain_matches_pallas`'s limit, 1e-5 of sum |x * w| per output
  (tests/test_torch_eagle_ops.py), on the rows normed with the Pallas
  kernel's inverse RMS. The port's inverse RMS sums in another order and
  differs from it in the last bit or two in about half the rows (held to
  2^-21 relative); that flips the bf16 rounding of a few normed values
  that lie on a rounding boundary (held to one bf16 step, at most 1e-4 of
  them), and one such flip moves an output by up to ~1e-4 of sum |x * w|.
  A bf16 x is given to the JAX side as the same values in f32, so both
  outputs are f32.
* K7i4's pre-pass (`k7_stage_plain` with `groups`) also gives the group
  sums xg of the unrounded normed rows: xn fed to
  `int4_matmul_plain(bf16_operands=True)` with those xg in the correction
  gives `int4_ln_matmul_plain(bf16_operands=True)` bit for bit, and xn's
  own (rounded) sums do not.
* `k7_block_rows`, K7's block height: 128 or 256 rows from the shape and
  the card only (256 where that grid keeps half the SMs busy; 128 with
  zero points or a packed weight), the grid covering every row.
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

torch.set_num_threads(2)
K7_TOL = 1e-5          # test_torch_eagle_ops.K7_TOL
EPS = 1e-5


def _case(n, din, dout, dtype, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, size=(din, dout)).astype(np.int8)
    scales = (np.abs(rng.standard_normal((din // 128, dout))) * 1e-2
              + 1e-3).astype(np.float32)
    jq = jlin.QuantizedLinear(qweight=jnp.asarray(codes),
                              scales=jnp.asarray(scales).astype(jnp.bfloat16),
                              zeros=None)
    x = torch.from_numpy(rng.standard_normal((n, din)).astype(np.float32))
    x = x.to(dtype)
    ln = torch.from_numpy((rng.random(din) + 0.5).astype(np.float32))
    return jq, bridge.convert(jq), x, ln


@pytest.mark.parametrize("din", [256, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [129, 480])
def test_k7_stage_feeds_the_fused_plain_bits(n, dtype, din):
    _, tq, x, ln = _case(n, din, 384, dtype, 10 * n + din)
    inv, xn = G.k7_stage_plain(x, ln, EPS)
    assert inv.shape == (n,) and inv.dtype == torch.float32
    assert xn.shape == (n, din) and xn.dtype == torch.bfloat16
    # the staging's arithmetic: (x * inv) * ln in f32, rounded once
    assert torch.equal(xn, ((x.float() * inv[:, None]) * ln).to(torch.bfloat16))
    split = G.int8_matmul_plain(xn.to(dtype), tq.qweight, tq.scales,
                                bf16_operands=True)
    fused = G.int8_ln_matmul_plain(x, tq.qweight, tq.scales, ln, EPS,
                                   bf16_operands=True)
    assert split.dtype == fused.dtype == dtype
    assert torch.equal(split, fused)
    # on the CPU the K7 wrapper is that plain version
    assert torch.equal(G.int8_matmul_bf16(x, tq.qweight, tq.scales, ln=ln,
                                          eps=EPS), fused)


@pytest.mark.parametrize("gs", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [129, 480])
def test_k7i4_stage_feeds_the_fused_plain_bits(n, dtype, gs):
    din, dout = 512, 384
    rng = np.random.default_rng(20 * n + gs)
    w = torch.from_numpy(rng.integers(0, 256, size=(din // 2, dout))
                         .astype(np.uint8))
    s = torch.from_numpy((np.abs(rng.standard_normal((din // gs, dout)))
                          * 1e-2 + 1e-3).astype(np.float32)).to(torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((n, din)).astype(np.float32))
    x = x.to(dtype)
    ln = torch.from_numpy((rng.random(din) + 0.5).astype(np.float32))
    inv, xn, xg = G.k7_stage_plain(x, ln, EPS, groups=din // gs)
    assert torch.equal(xn, G.k7_stage_plain(x, ln, EPS)[1])
    assert xg.shape == (n, din // gs) and xg.dtype == torch.float32
    # the sums of the normed rows before their rounding
    xs = (x.float() * inv[:, None]) * ln
    assert torch.equal(xg, xs.reshape(n, din // gs, gs).sum(-1))
    split = G.int4_matmul_plain(xn.to(dtype), w, s, bf16_operands=True,
                                xg=xg)
    fused = G.int4_ln_matmul_plain(x, w, s, ln, EPS, bf16_operands=True)
    assert split.dtype == fused.dtype == dtype
    assert torch.equal(split, fused)
    assert torch.equal(G.int4_matmul_bf16(x, w, s, ln=ln, eps=EPS), fused)
    # the rounded rows' own sums are another correction
    own = G.int4_matmul_plain(xn.to(dtype), w, s, bf16_operands=True)
    assert not torch.equal(own, fused)


@pytest.mark.parametrize("din", [256, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [129, 480])
def test_k7_split_matches_pallas(n, dtype, din):
    jq, tq, x, ln = _case(n, din, 256, dtype, 7 * n + din)
    xf = x.float()
    xj = jnp.asarray(xf.numpy())
    want = np.asarray(jgp.gptq_matmul(xj, jq, ln=jnp.asarray(ln.numpy()),
                                      ln_eps=EPS, interpret=True,
                                      mxu_bf16=True))
    # the Pallas kernel's inverse RMS (gptq_pallas._kernel_ln), which the
    # port's differs from in the last bit or two (another summation order)
    ref_inv = torch.from_numpy(np.array(
        jax.lax.rsqrt(jnp.mean(xj * xj, axis=1, keepdims=True) + EPS)))
    inv, xn = G.k7_stage_plain(x, ln, EPS)
    assert ((inv - ref_inv[:, 0]).abs() <= 2.0 ** -21 * ref_inv[:, 0]).all()
    # so xn is bf16 of the reference's normed x but where that value lies
    # on a rounding boundary, and there it is one bf16 step away
    ref_xn = ((xf * ref_inv) * ln).to(torch.bfloat16)
    diff = (xn.float() - ref_xn.float()).abs()
    step = 2.0 ** (torch.floor(torch.log2(ref_xn.float().abs())) - 7)
    assert (diff <= step).all()
    assert (diff > 0).sum().item() <= 1e-4 * n * din
    # the split form on the reference's rows: the product on a bf16 xn is
    # the Pallas bf16 mode within the limit
    got = G.int8_matmul_plain(ref_xn.float(), tq.qweight, tq.scales,
                              bf16_operands=True).numpy()
    xs = G._rms_f32(xf, ln, EPS)
    w = G.dequantize_int8(tq.qweight, tq.scales)
    mag = (xs.abs() @ w.abs()).numpy() + 1e-9
    assert (np.abs(got - want) / mag).max() < K7_TOL
    # the limit sees the rounding of xn: the unrounded normed x fails it
    unrounded = (xs @ G._bf16_round(w)).numpy()
    assert (np.abs(unrounded - want) / mag).max() > 10 * K7_TOL


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("dout", [256, 1001, 4096, 6144, 28672, 128256])
def test_k7_block_rows(dout, sms):
    for n in range(G.BF16_MIN_ROWS, G.BF16_MAX_ROWS + 1):
        bm = G.k7_block_rows(n, dout, sms)
        assert bm in (128, 256)
        blocks256 = -(-n // 256) * -(-dout // 128)
        assert (bm == 256) == (2 * blocks256 >= sms)
        assert -(-n // bm) * bm >= n > (-(-n // bm) - 1) * bm
        assert G.k7_block_rows(n, dout, sms, zeros=True) == 128
        assert G.k7_block_rows(n, dout, sms, packed=True) == 128
    # Llama-3.1-8B on 132 SMs: 256-row blocks where their grid keeps half
    # the SMs busy; wo and wdown at 480 rows (64 such blocks) and wqkv at
    # 129 (48) keep 128-row blocks, two an SM
    assert G.k7_block_rows(480, 28672, 132) == 256
    assert G.k7_block_rows(480, 128256, 132) == 256
    assert G.k7_block_rows(480, 6144, 132) == 256
    assert G.k7_block_rows(129, 28672, 132) == 256
    assert G.k7_block_rows(480, 4096, 132) == 128
    assert G.k7_block_rows(129, 6144, 132) == 128
