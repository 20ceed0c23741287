"""The arithmetic of K1 and K3's tensor-core kernel (`csrc/gptq_i8.cu`,
packed int4) against the JAX package on the CPU.

The kernel cannot run here, so a plain-torch model of its order stands in:
f32 activations (normed first for K1) split into three bf16 planes hi, mid
and lo that sum to them exactly; each plane times the exact UNSIGNED
nibbles (0..15, as stored) of a group, accumulated in f32 (the tensor
cores' exact products); the -8 and the zero point as one rank-1 term
acc - (8 + zero) * xg, xg the group's sum of the unrounded activations;
each group joined to the output as scale * acc. Split-half packing puts
feature r in the low nibble of packed row r and feature r + din/2 in its
high nibble, so packed-row group q carries groups q and G/2 + q: the model
joins them in the kernel's order, q's low group, then its high group, for
q = 0 .. G/2 - 1. The model is held, at 1, 11, 64 and 121 rows, symmetric
and asymmetric, with f32 and bf16 scales, against:
* the Pallas `_kernel_int4` / `_kernel_int4_ln` in interpret mode with f32
  operands (`gptq_matmul(..., interpret=True, mxu_bf16=False)`), and
* the port's plain versions (`int4_matmul_plain`, `int4_ln_matmul_plain`),
within 1e-5 of sum |x * w| per output, the measure of the K4/K5 and K7
tests. Two negative controls must fail that limit: one bf16 plane of the
normed activations (K7i4's arithmetic), and the signed weight staged in
bf16, bf16((nibble - 8) * scale). (bf16(nibble - 8) alone is exact: -8..7
are bf16 integers, so staging it would pass; the kernel stages the stored
nibble all the same, as JAX multiplies by it, and takes the -8 in the
rank-1 term.)

The nibble conversion the kernel uses is checked exhaustively: the bf16
bits 0x4300 | n are 128 + n, and 128 + n - 128 is n exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.ops import gptq_pallas as jgp
from hsd_tpu.ops import linear as jlin
from hsd_tpu_torch import bridge
from hsd_tpu_torch.ops import gptq_cuda as G

torch.set_num_threads(2)
TOL = 1e-5          # of sum |x * w| per output
DIN, DOUT, EPS = 512, 384, 1e-5


def _bf16(t):
    return t.to(torch.bfloat16).float()


def planes(x):
    """hi, mid, lo: bf16-valued f32 tensors with hi + mid + lo == x."""
    hi = _bf16(x)
    mid = _bf16(x - hi)
    lo = _bf16(x - hi - mid)
    return hi, mid, lo


def model(xs, qweight, scales, zeros=None, n_planes=3, signed_bf16=False):
    """The kernel's order on f32 (normed) activations xs [n, din]: per
    group, the planes times the stored nibbles in f32, the rank-1 term
    acc - (8 + zero) * xg, then scale * acc added to the output, packed-row
    group q's low group before its high group. signed_bf16: the negative
    control that stages bf16((nibble - 8) * scale) instead."""
    n, din = xs.shape
    groups = scales.shape[0]
    gs = din // groups
    nib = G._nibbles(qweight)                   # [din, dout], split-half
    ps = planes(xs)[:n_planes]
    s = scales.float()
    out = torch.zeros((n, qweight.shape[1]))
    for q in range(groups // 2):
        for g in (q, groups // 2 + q):
            f = slice(g * gs, (g + 1) * gs)
            if signed_bf16:
                w = _bf16((nib[f] - 8) * s[g])
                out = out + sum(p[:, f] @ w for p in ps)
                continue
            acc = torch.zeros_like(out)
            for p in ps:
                acc = acc + p[:, f] @ nib[f]
            c = 8.0 if zeros is None else zeros[g].float() + 8.0
            acc = acc - xs[:, f].sum(1, keepdim=True) * c
            out = out + s[g] * acc
    return out


def _case(seed, n, symmetric, scale_dtype, ln, gs=128):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((DIN, DOUT)).astype(np.float32)
    jq = jlin.quantize(jnp.asarray(w), bits=4, group_size=gs,
                       symmetric=symmetric)
    if scale_dtype == "bf16":
        jq = jq._replace(scales=jq.scales.astype(jnp.bfloat16))
    x = (rng.standard_normal((n, DIN)) * 3).astype(np.float32)
    lnw = (rng.random(DIN) + 0.5).astype(np.float32) if ln else None
    return jq, bridge.convert(jq), x, lnw


def _gap(got, want, mag):
    return float(((got - want).abs() / mag).max())


def _pallas(x, jq, lnw):
    kw = dict(ln=jnp.asarray(lnw), ln_eps=EPS) if lnw is not None else {}
    return torch.from_numpy(np.array(jgp.gptq_matmul(
        jnp.asarray(x), jq, interpret=True, mxu_bf16=False, **kw)))


def _scaled(tq, tx, tln):
    """The activations the kernel's planes carry, and sum |x| @ |w|."""
    xs = G._rms_f32(tx, tln, EPS) if tln is not None else tx
    w = G.dequantize_int4(tq.qweight, tq.scales, tq.zeros)
    return xs, xs.abs() @ w.abs() + 1e-9


CASES = [(sym, ln) for sym in (True, False) for ln in (False, True)
         if sym or not ln]          # the fused norm takes symmetric weights


@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("symmetric,ln", CASES)
@pytest.mark.parametrize("n", [1, 11, 64, 121])
def test_model_matches_pallas_and_plain(n, symmetric, ln, scale_dtype):
    jq, tq, x, lnw = _case(100 * n + 10 * symmetric + 2 * ln
                           + (scale_dtype == "bf16"), n, symmetric,
                           scale_dtype, ln)
    assert tq.qweight.dtype == torch.uint8
    assert (tq.zeros is None) == symmetric
    want = _pallas(x, jq, lnw)
    tx = torch.from_numpy(x)
    tln = torch.from_numpy(lnw) if ln else None
    xs, mag = _scaled(tq, tx, tln)
    got = model(xs, tq.qweight, tq.scales, tq.zeros)
    plain = (G.int4_ln_matmul_plain(tx, tq.qweight, tq.scales, tln, EPS)
             if ln else G.int4_matmul_plain(tx, tq.qweight, tq.scales,
                                            tq.zeros))
    assert _gap(got, want, mag) < TOL
    assert _gap(got, plain, mag) < TOL
    # the route the CPU takes is the plain version
    route = (G.int4_ln_matmul(tx, tq.qweight, tq.scales, tln, EPS) if ln
             else G.int4_matmul(tx, tq.qweight, tq.scales, tq.zeros))
    assert torch.equal(route, plain)


@pytest.mark.parametrize("symmetric,ln", CASES)
def test_model_matches_pallas_at_64_row_groups(symmetric, ln):
    """Groups of 64 features, the smallest the Pallas kernel takes: a
    packed-row group then spans 64 packed rows, two of the kernel's
    k-slices."""
    jq, tq, x, lnw = _case(9, 11, symmetric, "bf16", ln, gs=64)
    tx = torch.from_numpy(x)
    tln = torch.from_numpy(lnw) if ln else None
    xs, mag = _scaled(tq, tx, tln)
    got = model(xs, tq.qweight, tq.scales, tq.zeros)
    assert _gap(got, _pallas(x, jq, lnw), mag) < TOL


@pytest.mark.parametrize("control", ["one_plane_normed", "signed_bf16"])
def test_negative_controls_fail(control):
    ln = control == "one_plane_normed"
    jq, tq, x, lnw = _case(5, 64, True, "f32", ln)
    want = _pallas(x, jq, lnw)
    tx = torch.from_numpy(x)
    xs, mag = _scaled(tq, tx, torch.from_numpy(lnw) if ln else None)
    if ln:       # K7i4's arithmetic: the normed activations rounded to bf16
        bad = model(xs, tq.qweight, tq.scales, n_planes=1)
    else:        # the weight staged as bf16((nibble - 8) * scale)
        bad = model(xs, tq.qweight, tq.scales, signed_bf16=True)
    assert _gap(bad, want, mag) > 10 * TOL
    # the signed nibble itself is exact in bf16: staging it is no control
    nib = G._nibbles(tq.qweight)
    assert torch.equal(_bf16(nib - 8), nib - 8)


def test_nibble_conversion_is_exact():
    """The kernel's nibble to bf16: the bits 0x4300 | n are 128 + n, less
    128 (a bf16 subtraction) n exactly, for every nibble."""
    n = torch.arange(16, dtype=torch.int32)
    biased = (0x4300 | n).to(torch.int16).view(torch.bfloat16)
    assert torch.equal(biased.float(), 128.0 + n.float())
    exact = biased - torch.tensor(128.0, dtype=torch.bfloat16)
    assert exact.dtype == torch.bfloat16
    assert torch.equal(exact.float(), n.float())
