"""The arithmetic of K4 and K5's tensor-core kernel (`csrc/gptq_i8.cu`)
against the JAX package on the CPU.

The kernel cannot run here, so a plain-torch model of its order stands in:
f32 activations (normed first for K5) split into three bf16 planes hi, mid
and lo that sum to them exactly; each plane times the exact int8 codes of a
group, accumulated in f32 (the tensor cores' exact products); the zero point
as the rank-1 term acc - zero * xg, xg the group's sum of the unrounded
activations; each group joined to the output as scale * acc, groups in
order. The model is held, at 1, 7 and 64 rows, symmetric and asymmetric,
with f32 and bf16 scales, against:
* the Pallas `_kernel` / `_kernel_ln` in interpret mode with f32 operands
  (`gptq_matmul(..., interpret=True, mxu_bf16=False)`), and
* the port's plain versions (`int8_matmul_plain`, `int8_ln_matmul_plain`),
within 1e-5 of sum |x * w| per output, the measure of the K7 tests. Two
negative controls must fail that limit: one bf16 plane of the normed
activations (K7's arithmetic) and a dropped zero term.

The plane split itself is checked bit for bit (hi + mid + lo == x) on over
1e5 values: random normals, values within a decade of 1e30 and of 1e-30,
and rows normed as `_rms_f32` norms them; bf16 inputs have zero mid and lo
planes. (Below about 2^-110, lo would fall under bf16's subnormal spacing
of 2^-133 and the split stops being exact; no activation of the port comes
near that.)
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


def model(xs, codes, scales, zeros=None, n_planes=3):
    """The kernel's order on f32 (normed) activations xs [n, din]: per
    group, the planes times the codes in f32, the zero point's rank-1 term,
    then scale * acc added to the output, groups in order."""
    n, din = xs.shape
    groups = scales.shape[0]
    gs = din // groups
    ps = planes(xs)[:n_planes]
    c = codes.float()
    s = scales.float()
    out = torch.zeros((n, codes.shape[1]))
    for g in range(groups):
        f = slice(g * gs, (g + 1) * gs)
        acc = torch.zeros_like(out)
        for p in ps:
            acc = acc + p[:, f] @ c[f]
        if zeros is not None:
            acc = acc - xs[:, f].sum(1, keepdim=True) * zeros[g]
        out = out + s[g] * acc
    return out


def _case(seed, n, symmetric, scale_dtype, ln):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((DIN, DOUT)).astype(np.float32)
    jq = jlin.quantize(jnp.asarray(w), bits=8, group_size=128,
                       symmetric=symmetric)
    if scale_dtype == "bf16":
        jq = jq._replace(scales=jq.scales.astype(jnp.bfloat16))
    x = (rng.standard_normal((n, DIN)) * 3).astype(np.float32)
    lnw = (rng.random(DIN) + 0.5).astype(np.float32) if ln else None
    return jq, bridge.convert(jq), x, lnw


def _gap(got, want, mag):
    return float(((got - want).abs() / mag).max())


CASES = [(sym, ln) for sym in (True, False) for ln in (False, True)
         if sym or not ln]          # the fused norm takes symmetric weights


@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("symmetric,ln", CASES)
@pytest.mark.parametrize("n", [1, 7, 64])
def test_model_matches_pallas_and_plain(n, symmetric, ln, scale_dtype):
    jq, tq, x, lnw = _case(100 * n + 10 * symmetric + 2 * ln
                           + (scale_dtype == "bf16"), n, symmetric,
                           scale_dtype, ln)
    assert tq.qweight.dtype == torch.int8
    assert (tq.zeros is None) == symmetric
    kw = dict(ln=jnp.asarray(lnw), ln_eps=EPS) if ln else {}
    want = torch.from_numpy(np.asarray(jgp.gptq_matmul(
        jnp.asarray(x), jq, interpret=True, mxu_bf16=False, **kw)))
    tx = torch.from_numpy(x)
    tln = torch.from_numpy(lnw) if ln else None
    xs = G._rms_f32(tx, tln, EPS) if ln else tx
    got = model(xs, tq.qweight, tq.scales, tq.zeros)
    w = G.dequantize_int8(tq.qweight, tq.scales, tq.zeros)
    mag = xs.abs() @ w.abs() + 1e-9
    plain = (G.int8_ln_matmul_plain(tx, tq.qweight, tq.scales, tln, EPS) if ln
             else G.int8_matmul_plain(tx, tq.qweight, tq.scales, tq.zeros))
    assert _gap(got, want, mag) < TOL
    assert _gap(got, plain, mag) < TOL
    # the route the CPU takes is the plain version
    route = (G.int8_ln_matmul(tx, tq.qweight, tq.scales, tln, EPS) if ln
             else G.int8_matmul(tx, tq.qweight, tq.scales, tq.zeros))
    assert torch.equal(route, plain)


def _normed_rows(rng, rows):
    x = torch.from_numpy(rng.standard_normal((rows, 4096)).astype(np.float32))
    ln = torch.from_numpy((rng.random(4096) + 0.5).astype(np.float32))
    return G._rms_f32(x * 50, ln, EPS)


@pytest.mark.parametrize("kind", ["normal", "huge", "tiny", "normed"])
def test_planes_sum_exactly(kind):
    rng = np.random.default_rng(7)
    if kind == "normed":
        x = _normed_rows(rng, 32)
    else:
        x = rng.standard_normal(131072)
        if kind != "normal":        # magnitudes within a decade of 1e+-30
            x = np.sign(x) * 10.0 ** (rng.uniform(-0.5, 0.5, x.shape)
                                      + (30 if kind == "huge" else -30))
        x = torch.from_numpy(x.astype(np.float32))
    assert x.numel() >= 1e5
    hi, mid, lo = planes(x)
    for p in (hi, mid, lo):
        assert torch.equal(_bf16(p), p)          # each plane is bf16
    assert torch.equal((hi + mid) + lo, x)
    assert torch.equal(hi + (mid + lo), x)
    xb = _bf16(x)                                # a bf16 input: one plane
    _, mid_b, lo_b = planes(xb)
    assert not mid_b.any() and not lo_b.any()


@pytest.mark.parametrize("control", ["one_plane_normed", "no_zero_term"])
def test_negative_controls_fail(control):
    ln = control == "one_plane_normed"
    jq, tq, x, lnw = _case(5, 64, ln, "f32", ln)
    kw = dict(ln=jnp.asarray(lnw), ln_eps=EPS) if ln else {}
    want = torch.from_numpy(np.asarray(jgp.gptq_matmul(
        jnp.asarray(x), jq, interpret=True, mxu_bf16=False, **kw)))
    tx = torch.from_numpy(x)
    xs = G._rms_f32(tx, torch.from_numpy(lnw), EPS) if ln else tx
    w = G.dequantize_int8(tq.qweight, tq.scales, tq.zeros)
    mag = xs.abs() @ w.abs() + 1e-9
    if ln:       # K7's arithmetic: the normed activations rounded to bf16
        bad = model(xs, tq.qweight, tq.scales, n_planes=1)
    else:
        bad = model(xs, tq.qweight, tq.scales, None)
    assert _gap(bad, want, mag) > 10 * TOL
