"""The port's route for quantized products of more than 128 rows outside
the bf16-operand mode, against the JAX package on the CPU.

On its device the JAX package runs such a product through XLA, not Pallas
(`_use_pallas`, hsd_tpu/ops/linear.py:193-225): `_rms_xla` norms x and
rounds it to the activation dtype, then `_gptq_matmul_xla` dequantizes the
weight to that dtype and runs one einsum (`:124-143, 168-170`). The port's
`dequant_matmul` does the same in plain PyTorch. Held here:
* the gate (`kernel_route`) against `_use_pallas` with the backend
  reported as "tpu", over row counts either side of 128 and 1024, with and
  without mxu_bf16, for symmetric and asymmetric int8 and packed-int4
  weights, one shape whose `batched_rows_ok` fails at 693 rows and one the
  Pallas kernel does not take;
* the arithmetic in f32 at 129 and 693 rows, with and without the norm,
  against the reference's route (`apply_linear` off the TPU, i.e.
  `_rms_xla` then `_gptq_matmul_xla`): within 1e-6 of sum |x * w| per
  output (f32 summation order only);
* the bf16 roundings bit for bit: `dequantize(w, bf16)` against
  `jlin.dequantize`, `rms_norm` against `_rms_xla`'s ops given the same
  inverse RMS (XLA's CPU rsqrt is not correctly rounded); XLA's CPU
  backend has no bf16 dot, so the dot in bf16 is held to a model: the
  rounded operands in f32, rounded once;
* which calls take the route: every call of more than 128 rows outside
  the bf16 mode, and no kernel-eligible call;
* a negative control: the fused f32 norm and f32 weight the port used for
  these calls before differ from the route in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.ops import linear as jlin
from hsd_tpu_torch import bridge
from hsd_tpu_torch.ops import gptq_cuda as G
from hsd_tpu_torch.ops import linear as tlin

torch.set_num_threads(2)
EPS = 1e-5
ROWS = [1, 64, 128, 129, 693, 1024, 1025]
KERNELS = ("int4_ln_matmul", "int4_matmul", "int8_matmul", "int8_ln_matmul",
           "int8_matmul_bf16", "int4_matmul_bf16")


def _np(t):
    return t.detach().float().numpy()


def _weight(kind, seed=0):
    """(JAX weight, port weight) of a named shape and format."""
    rng = np.random.default_rng(seed)
    bits, sym, din, dout, gs = {
        "int8 sym": (8, True, 256, 256, 128),
        "int8 asym": (8, False, 256, 256, 128),
        "int4 sym": (4, True, 256, 384, 128),
        "int4 asym": (4, False, 256, 384, 128),
        # 8192 int8 in-rows: the batched VMEM budget fails past 662 rows
        "int8 sym wide-in": (8, True, 8192, 128, 128),
        # groups of 64 int8 rows: the Pallas kernel does not take it
        "int8 sym gs64": (8, True, 256, 256, 64),
    }[kind]
    w = rng.standard_normal((din, dout)).astype(np.float32)
    jq = jlin.quantize(jnp.asarray(w), bits=bits, group_size=gs,
                       symmetric=sym)
    if sym:
        jq = jq._replace(scales=jq.scales.astype(jnp.bfloat16))
    return jq, bridge.convert(jq)


GATE_KINDS = ["int8 sym", "int8 asym", "int4 sym", "int4 asym",
              "int8 sym wide-in", "int8 sym gs64"]


@pytest.mark.parametrize("kind", GATE_KINDS)
def test_gate_matches_reference_rule(kind, monkeypatch):
    jq, tq = _weight(kind)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    table = []
    for n in ROWS:
        x = jnp.zeros((n, tq.din), jnp.float32)
        for mxu in (False, True):
            want = jlin._use_pallas(x, jq, "auto", mxu)
            got = tlin.kernel_route(tq, n, mxu)
            table.append((n, mxu, want))
            assert got == want, (kind, n, mxu)
    # the table has both answers where the rule has them
    if kind == "int8 sym wide-in":
        assert (129, True, True) in table and (693, True, False) in table
    if kind == "int8 sym gs64":
        assert not any(w for _, _, w in table)


def _forbid(monkeypatch, names):
    """Make the named kernel wrappers, as linear.py reaches them, raise."""
    def boom(*a, **k):
        raise AssertionError("a kernel wrapper ran")
    for name in names:
        monkeypatch.setattr(tlin.gptq_cuda, name, boom)


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("kind", ["int8 sym", "int8 asym", "int4 sym",
                                  "int4 asym"])
@pytest.mark.parametrize("n", [129, 693])
def test_f32_route_matches_xla(n, kind, norm, monkeypatch):
    jq, tq = _weight(kind, seed=n)
    rng = np.random.default_rng(n + 1)
    x = (rng.standard_normal((n, tq.din)) * 2).astype(np.float32)
    ln = (rng.random(tq.din) + 0.5).astype(np.float32)
    rms = (jnp.asarray(ln), EPS) if norm else None
    # off the TPU the reference takes its XLA route: _rms_xla, then
    # _gptq_matmul_xla (dequantize-then-dot above 64 rows)
    want = np.asarray(jlin.apply_linear(jq, jnp.asarray(x), rms=rms))
    xs = jlin._rms_xla(jnp.asarray(x), rms[0], EPS) if norm else x
    np.testing.assert_array_equal(
        np.asarray(jlin._gptq_matmul_xla(jnp.asarray(xs), jq)), want)
    _forbid(monkeypatch, KERNELS)         # the route runs no kernel
    got = tlin.apply_linear(tq, torch.from_numpy(x),
                            norm=(torch.from_numpy(ln), EPS) if norm else None)
    w = tlin.dequantize(tq, torch.float32)
    mag = np.abs(np.asarray(xs)) @ np.abs(_np(w)) + 1e-9
    assert (np.abs(_np(got) - want) / mag).max() < 1e-6


@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["int8 sym", "int8 asym", "int4 sym",
                                  "int4 asym"])
def test_dequantize_bits_match_reference(kind, scale_dtype):
    jq, tq = _weight(kind, seed=3)
    dt = jnp.bfloat16 if scale_dtype == "bf16" else jnp.float32
    jq = jq._replace(scales=jq.scales.astype(dt))
    tq = bridge.convert(jq)
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        got = tlin.dequantize(tq, dtype)
        want = np.asarray(jlin.dequantize(jq, jdtype))
        assert got.dtype == dtype
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        np.testing.assert_array_equal(
            got.view(bits).numpy(),
            want.view(np.int16 if dtype == torch.bfloat16 else np.int32))
    # a desc_act weight comes back in the original row order on both sides
    perm = np.random.default_rng(4).permutation(tq.din).astype(np.int32)
    got = tlin.dequantize(tq._replace(perm=torch.from_numpy(perm).long()))
    want = np.asarray(jlin.dequantize(jq._replace(perm=jnp.asarray(perm))))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


@pytest.mark.parametrize("scale", [1.0, 40.0])
def test_rms_norm_bits_match_reference(scale):
    """rms_norm == _rms_xla, bf16 in and out, on 1.3e5 activations: bit
    for bit given the same inverse RMS. XLA's CPU rsqrt is not correctly
    rounded and the mean's summation order may differ: the two inverse
    RMS differ by a few ulps, which flips the bf16 rounding of about one
    activation in 1e5."""
    rng = np.random.default_rng(int(scale))
    x = (rng.standard_normal((64, 2048)) * scale).astype(np.float32)
    ln = (rng.random(2048) + 0.5).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jlin._rms_xla(xb, jnp.asarray(ln), EPS))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tlin.rms_norm(xt, torch.from_numpy(ln), EPS)
    assert got.dtype == torch.bfloat16
    xf = xt.float()
    r_t = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + EPS)
    xj = xb.astype(jnp.float32)
    r_j = jax.lax.rsqrt(jnp.mean(xj * xj, axis=-1, keepdims=True) + EPS)
    ulps = np.abs(r_t.numpy().view(np.int32) - np.asarray(r_j).view(np.int32))
    assert ulps.max() <= 4
    # _rms_xla's ops on the port's inverse RMS: the same bits
    same_r = np.asarray((xj * jnp.asarray(r_t.numpy()) * jnp.asarray(ln))
                        .astype(jnp.bfloat16))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  same_r.view(np.int16))
    flips = int((got.view(torch.int16).numpy() != want.view(np.int16)).sum())
    assert flips <= 4, flips


def _bf16_case(kind, n, seed):
    jq, tq = _weight(kind, seed=seed)
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.standard_normal((n, tq.din)).astype(
        np.float32)).to(torch.bfloat16)
    ln = torch.from_numpy((rng.random(tq.din) + 0.5).astype(np.float32))
    return tq, x, ln


@pytest.mark.parametrize("kind", ["int4 sym", "int8 sym", "int4 asym"])
def test_bf16_route_rounds_as_reference(kind, monkeypatch):
    """In bf16 the route rounds the normed x and the weight to bf16, dots
    in f32 and rounds once: equal to that model within one bf16 step of
    the output (the dot's f32 order), while the fused f32 route the port
    took before (K1 / K5's plain version: the normed x unrounded, the
    weight f32) differs from it."""
    tq, x, ln = _bf16_case(kind, 129, 11)
    _forbid(monkeypatch, KERNELS)
    got = tlin.apply_linear(tq, x, norm=(ln, EPS))
    xn = tlin.rms_norm(x, ln, EPS)
    model = (xn.float() @ tlin.dequantize(tq, torch.bfloat16).float()).to(
        torch.bfloat16)
    assert got.dtype == torch.bfloat16
    step = 2.0 ** -8 * model.float().abs().max().item()
    assert (got.float() - model.float()).abs().max().item() <= step
    if kind == "int4 asym":
        return
    fused = (G.int4_ln_matmul_plain if tq.packed_int4
             else G.int8_ln_matmul_plain)
    old = fused(x, tq.qweight, tq.scales, ln, EPS)
    assert not torch.equal(old, got)
    assert (old.float() != model.float()).float().mean().item() > 0.05


def test_route_taken_exactly_where_the_gate_says(monkeypatch):
    """Above 128 rows outside the bf16 mode every call takes the route;
    no kernel-eligible call does."""
    calls = []
    real = tlin.dequant_matmul
    monkeypatch.setattr(tlin, "dequant_matmul",
                        lambda x, w: calls.append(x.shape[0]) or real(x, w))
    for kind in ("int8 sym", "int8 asym", "int4 sym", "int4 asym"):
        _, tq = _weight(kind, seed=5)
        ln = torch.rand(tq.din) + 0.5
        for n in (1, 128, 129, 693, 1024, 1025):
            x = torch.randn(n, tq.din).to(torch.bfloat16)
            for mxu in (False, True):
                for norm in (None, (ln, EPS)):
                    calls.clear()
                    tlin.apply_linear(tq, x, norm=norm, mxu_bf16=mxu)
                    routed = not tlin.kernel_route(tq, n, mxu)
                    assert calls == ([n] if routed else []), (kind, n, mxu)
                    assert routed == (n > 128 and not (mxu and n <= 1024))
    # a layer-stacked weight routes on its selected layer's rows
    _, tq = _weight("int4 sym", seed=6)
    stacked = tlin.QuantizedLinear(*(t[None].expand(2, *t.shape)
                                     if t is not None else None
                                     for t in tq[:3]))
    calls.clear()
    x = torch.randn(3, 100, tq.din)
    y = tlin.apply_linear(stacked, x, layer=1)
    assert calls == [300] and y.shape == (3, 100, 384)


def test_route_checks_tf32(monkeypatch):
    _, tq = _weight("int4 sym")
    x = torch.randn(129, tq.din)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        tlin.apply_linear(tq, x)
    # bf16 products are not affected by the flag
    tlin.apply_linear(tq, x.to(torch.bfloat16))
