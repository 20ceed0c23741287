"""The arithmetic of K2 and K6 (the fused packed-int4 layer tail and MLP) as
products of the int4 tensor-core kernel (`csrc/gptq_i8.cu`), against the
JAX package on the CPU.

The kernel cannot run here, so a plain-torch model of its order stands in,
product by product as `hsd_gptq_tail` runs them:
* wo on the attention output's planes (one for bf16 values, three for f32),
  its splits' f32 partials summed in split order, then resid added in f32:
  x' (K2 only);
* wgu on K1's pre-pass over x' (K6: over x): the normed f32 activations as
  three bf16 planes and each group's f32 sum for the rank-1 -8 term;
* the SwiGLU in f32, ff = silu(g) * u, pairing columns j and F + j;
* wdown on ff's three planes (split in the kernel), the split sum, then x'
  added last (K6: nothing) and one rounding.
Each product is the kernel's order of `tests/test_torch_int4_planes.py`:
per group the planes times the stored nibbles, acc - 8 * xg, scale * acc
into the split's partial, a packed-row group's low group before its high
group. The splits are the card's (`splits_for` on an H100's 132 SMs).

The model is held, at 1, 7, 11 and 32 rows, with f32 and bf16 activations
and f32 and bf16 scales, against `gptq_attn_mlp_int4` / `gptq_mlp_int4` in
Pallas interpret mode (f32 arithmetic throughout) and against the port's
plain versions, within 1e-5 of sum |x * w| per output: |x'| + |ff| @
|deq(Wdown)| for K2, |ff| @ |deq(Wdown)| for K6. bf16 activations are
compared before the output's one rounding: the Pallas kernel given their
values in f32, after checking that its bf16 output is exactly that result
rounded. The negative control, ff rounded to bf16 before wdown (one plane,
as a bf16 staging would give), must fail the limit.
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
D, FF, EPS = 512, 1024, 1e-5      # hidden (= attention) width, MLP width
H100_SMS = 132


def _bf16(t):
    return t.to(torch.bfloat16).float()


def planes(x):
    """hi, mid, lo: bf16-valued f32 tensors with hi + mid + lo == x."""
    hi = _bf16(x)
    mid = _bf16(x - hi)
    return hi, mid, _bf16(x - hi - mid)


def product(xs, qweight, scales, n_planes=3):
    """One symmetric packed-int4 product in the kernel's order: each split's
    f32 partial over its packed-row groups (low group, then high), summed
    in split order. Groups of 128 features: one 128-row split tile each."""
    n, din = xs.shape
    dout = qweight.shape[1]
    groups = scales.shape[0]
    gs, half = din // groups, groups // 2
    assert gs == 128
    splits = G.splits_for(qweight.shape[0], dout, H100_SMS)
    per = -(-half // splits)
    nib = G._nibbles(qweight)
    s = scales.float()
    ps = planes(xs)[:n_planes]
    total = None
    for z in range(splits):
        part = torch.zeros((n, dout))
        for q in range(z * per, min(half, (z + 1) * per)):
            for g in (q, half + q):
                f = slice(g * gs, (g + 1) * gs)
                acc = torch.zeros((n, dout))
                for p in ps:
                    acc = acc + p[:, f] @ nib[f]
                acc = acc - xs[:, f].sum(1, keepdim=True) * 8.0
                part = part + s[g] * acc
        total = part if total is None else total + part
    return total


def model(x, resid, wo, wgu, wdown, ln, bf16_x, ff_bf16=False):
    """The tail (resid given) or the MLP (wo, resid None) in the kernel's
    order, unrounded; returns (out, x' or None, ff). ff_bf16: the negative
    control, ff rounded to bf16 and staged as one plane."""
    xp = None
    if resid is not None:
        xp = resid + product(x, wo.qweight, wo.scales, 1 if bf16_x else 3)
    xn = G._rms_f32(xp if xp is not None else x, ln, EPS)
    gu = product(xn, wgu.qweight, wgu.scales)
    g, u = gu[:, :FF], gu[:, FF:]
    ff = g * torch.sigmoid(g) * u
    if ff_bf16:
        y = product(_bf16(ff), wdown.qweight, wdown.scales, 1)
    else:
        y = product(ff, wdown.qweight, wdown.scales)
    return (y if xp is None else xp + y), xp, ff


def _jq(rng, din, dout, scale_dtype):
    w = (rng.standard_normal((din, dout)) * din ** -0.5).astype(np.float32)
    jq = jlin.quantize(jnp.asarray(w), bits=4, group_size=128, symmetric=True)
    if scale_dtype == "bf16":
        jq = jq._replace(scales=jq.scales.astype(jnp.bfloat16))
    return jq


def _case(seed, n, act, scale_dtype):
    rng = np.random.default_rng(seed)
    jws = [_jq(rng, D, D, scale_dtype), _jq(rng, D, 2 * FF, scale_dtype),
           _jq(rng, FF, D, scale_dtype)]
    x, resid = (rng.standard_normal((2, n, D)) * 2).astype(np.float32)
    if act == "bf16":       # bf16 values, held in f32
        x, resid = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                    for a in (x, resid))
    ln = (rng.random(D) + 0.5).astype(np.float32)
    return jws, [bridge.convert(j) for j in jws], x, resid, ln


def _pallas(k2, x, resid, jws, ln, act):
    """The Pallas kernel in interpret mode on f32 operands; for bf16
    activations, also on bf16 ones, whose output must be the f32 result
    rounded once."""
    def call(dt):
        if k2:
            return jgp.gptq_attn_mlp_int4(
                jnp.asarray(x, dt), jnp.asarray(resid, dt), *jws,
                jnp.asarray(ln), ln_eps=EPS, interpret=True)
        return jgp.gptq_mlp_int4(jnp.asarray(x, dt), jws[1], jws[2],
                                 jnp.asarray(ln), ln_eps=EPS, interpret=True)
    want = call(jnp.float32)
    if act == "bf16":
        rounded = np.asarray(call(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(
            rounded, np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32)))
    return torch.from_numpy(np.array(want))


def _mag(xp, ff, wdown):
    m = ff.abs() @ G.dequantize_int4(wdown.qweight, wdown.scales).abs()
    return (m if xp is None else xp.abs() + m) + 1e-9


def _gap(got, want, mag):
    return float(((got - want).abs() / mag).max())


@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 7, 11, 32])
@pytest.mark.parametrize("kernel", ["K2", "K6"])
def test_model_matches_pallas_and_plain(kernel, n, act, scale_dtype):
    k2 = kernel == "K2"
    jws, (wo, wgu, wdown), x, resid, ln = _case(
        1000 * k2 + 10 * n + 2 * (act == "bf16") + (scale_dtype == "bf16"),
        n, act, scale_dtype)
    if k2:
        assert jgp.attn_mlp_fusion_supported(jnp.asarray(x), *jws)
    else:
        assert jgp.mlp_fusion_supported(jnp.asarray(x), jws[1], jws[2])
    tx, tres, tln = (torch.from_numpy(a) for a in (x, resid, ln))
    got, xp, ff = model(tx, tres if k2 else None, wo, wgu, wdown, tln,
                        act == "bf16")
    mag = _mag(xp, ff, wdown)
    assert _gap(got, _pallas(k2, x, resid, jws, ln, act), mag) < TOL
    if k2:
        args = (tx, tres, wo.qweight, wo.scales, wgu.qweight, wgu.scales,
                wdown.qweight, wdown.scales, tln, EPS)
        plain, route = G.attn_mlp_int4_plain(*args), G.attn_mlp_int4(*args)
    else:
        args = (tx, wgu.qweight, wgu.scales, wdown.qweight, wdown.scales,
                tln, EPS)
        plain, route = G.mlp_int4_plain(*args), G.mlp_int4(*args)
    assert _gap(got, plain, mag) < TOL
    # the route the CPU takes is the plain version
    assert torch.equal(route, plain)


@pytest.mark.parametrize("kernel", ["K2", "K6"])
def test_bf16_ff_control_fails(kernel):
    """ff rounded to bf16 before wdown (what staging it in bf16 would do)
    must fail the limit the model meets."""
    k2 = kernel == "K2"
    jws, (wo, wgu, wdown), x, resid, ln = _case(7 + k2, 11, "f32", "f32")
    tx, tres, tln = (torch.from_numpy(a) for a in (x, resid, ln))
    want = _pallas(k2, x, resid, jws, ln, "f32")
    good, xp, ff = model(tx, tres if k2 else None, wo, wgu, wdown, tln, False)
    bad, _, _ = model(tx, tres if k2 else None, wo, wgu, wdown, tln, False,
                      ff_bf16=True)
    mag = _mag(xp, ff, wdown)
    assert _gap(good, want, mag) < TOL
    assert _gap(bad, want, mag) > 10 * TOL


def test_model_splits_are_the_cards():
    """The model's products split as the kernel's do on an H100, and every
    product of this shape is split: the ordered split sum is exercised."""
    _, (wo, wgu, wdown), *_ = _case(3, 1, "f32", "f32")
    assert [G.splits_for(w.qweight.shape[0], w.qweight.shape[1], H100_SMS)
            for w in (wo, wgu, wdown)] == [2, 2, 4]
