"""The port's route for quantized products that no kernel takes, at any row
count, against the JAX package's XLA route on the CPU.

On its device the JAX package runs a product through `_gptq_matmul_xla`
(hsd_tpu/ops/linear.py:146-182) wherever `_use_pallas` (:193-225) declines
it: above 128 rows outside the bf16 mode, and at every row count on a shape
its Pallas kernel does not take (int8 groups of 64 rows, out widths that
are not a multiple of 128, odd packed group counts). At most 64 rows that
route sums grouped partial products in f32 (codes in the activation dtype,
times the scales, less the rank-1 zero term); above 64 it dequantizes and
runs one dot. The port's `xla_matmul` does the same in plain PyTorch, and
`apply_linear` sends every call that `kernel_route` declines to it. Held
here, on shapes the kernels do not take, at 1, 11, 64, 65 and 128 rows:
* f32, with and without the norm, against the reference's route
  (`apply_linear` off the TPU: `_rms_xla`, then `_gptq_matmul_xla`) within
  1e-6 of sum |x * w| per output (f32 summation order only);
* bf16 against a model of its roundings: the bf16 activations and the
  exact codes times the f32 scales (at most 64 rows) or the weight rounded
  to bf16 (above 64), dotted in f32 and rounded once; within one bf16 step
  of the output (the f32 order). XLA's CPU backend has no bf16 dot, so the
  reference is not run in bf16;
* which calls take the route: every call on those shapes, with and
  without mxu_bf16 and the norm, and no kernel wrapper; no call that
  `kernel_route` admits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.ops import linear as jlin
from hsd_tpu_torch import bridge
from hsd_tpu_torch.ops import linear as tlin

torch.set_num_threads(2)
EPS = 1e-5
ROWS = [1, 11, 64, 65, 128]
KERNELS = ("int4_ln_matmul", "int4_matmul", "int8_matmul", "int8_ln_matmul",
           "int8_matmul_bf16", "int4_matmul_bf16")
# (bits, din, dout, group size): shapes `pallas_supported` rejects
SHAPES = {
    "int8 gs64": (8, 256, 256, 64),
    "int8 out64": (8, 256, 64, 128),
    "int8 out192": (8, 256, 192, 128),
    "int4 out64": (4, 256, 64, 64),
    "int4 out192": (4, 256, 192, 128),
    "int4 odd groups": (4, 384, 256, 128),
}
KINDS = [(shape, sym) for shape in SHAPES for sym in (True, False)]


def _np(t):
    return t.detach().float().numpy()


def _weight(shape, sym, seed):
    """(JAX weight, port weight) of a named shape, symmetric or not."""
    bits, din, dout, gs = SHAPES[shape]
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((din, dout)).astype(np.float32)
    jq = jlin.quantize(jnp.asarray(w), bits=bits, group_size=gs,
                       symmetric=sym)
    return jq, bridge.convert(jq)


def _forbid(monkeypatch, names):
    """Make the named kernel wrappers, as linear.py reaches them, raise."""
    def boom(*a, **k):
        raise AssertionError("a kernel wrapper ran")
    for name in names:
        monkeypatch.setattr(tlin.gptq_cuda, name, boom)


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("shape,sym", KINDS)
def test_f32_route_matches_xla(shape, sym, norm, monkeypatch):
    jq, tq = _weight(shape, sym, seed=len(shape) + 2 * sym + norm)
    assert not tlin.pallas_supported(tq)
    _forbid(monkeypatch, KERNELS)
    rng = np.random.default_rng(7 + norm)
    ln = (rng.random(tq.din) + 0.5).astype(np.float32)
    w = _np(tlin.dequantize(tq, torch.float32))
    for n in ROWS:
        x = (rng.standard_normal((n, tq.din)) * 2).astype(np.float32)
        rms = (jnp.asarray(ln), EPS) if norm else None
        want = np.asarray(jlin.apply_linear(jq, jnp.asarray(x), rms=rms))
        xs = np.array(jlin._rms_xla(jnp.asarray(x), rms[0], EPS)
                      if norm else x)
        np.testing.assert_array_equal(
            np.asarray(jlin._gptq_matmul_xla(jnp.asarray(xs), jq)), want)
        got = tlin.apply_linear(
            tq, torch.from_numpy(x),
            norm=(torch.from_numpy(ln), EPS) if norm else None)
        assert got.dtype == torch.float32 and got.shape == want.shape
        mag = np.abs(xs) @ np.abs(w) + 1e-9
        assert (np.abs(_np(got) - want) / mag).max() < 1e-6, n
        # the port's route by itself, on the normed rows
        direct = tlin.xla_matmul(torch.from_numpy(xs), tq)
        assert (np.abs(_np(direct) - want) / mag).max() < 1e-6, n


@pytest.mark.parametrize("shape,sym", KINDS)
def test_bf16_route_rounds_as_reference(shape, sym, monkeypatch):
    _, tq = _weight(shape, sym, seed=100 + len(shape) + sym)
    _forbid(monkeypatch, KERNELS)
    rng = np.random.default_rng(8)
    w32 = tlin.dequantize(tq, torch.float32)
    w16 = tlin.dequantize(tq, torch.bfloat16).float()
    for n in ROWS:
        x = torch.from_numpy(rng.standard_normal((n, tq.din)).astype(
            np.float32)).to(torch.bfloat16)
        got = tlin.apply_linear(tq, x)
        assert got.dtype == torch.bfloat16
        # at most 64 rows the codes and scales stay exact (the grouped
        # partials); above 64 the weight rounds to bf16 first
        model = (x.float() @ (w32 if n <= 64 else w16)).to(torch.bfloat16)
        step = 2.0 ** -8 * model.float().abs().max().item()
        assert (got.float() - model.float()).abs().max().item() <= step, n
        if n > 64:
            assert torch.equal(got, tlin.dequant_matmul(x, tq))


def test_partials_keep_the_weight_unrounded():
    """A negative control for the bf16 model: at 64 rows the grouped
    partials differ from dequantize-then-dot, whose bf16 weight rounds,
    in many outputs; the two routes meet above 64 rows."""
    _, tq = _weight("int8 gs64", False, seed=5)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (65, tq.din)).astype(np.float32)).to(torch.bfloat16)
    partial = tlin.xla_matmul(x[:64], tq)
    deq = tlin.dequant_matmul(x[:64], tq)
    assert (partial != deq).float().mean().item() > 0.05
    assert torch.equal(tlin.xla_matmul(x, tq), tlin.dequant_matmul(x, tq))


def test_route_taken_exactly_where_the_gate_says(monkeypatch):
    """Every call on a shape no kernel takes takes the route, at every row
    count, with and without mxu_bf16 and the norm, and reaches no kernel
    wrapper; a call that kernel_route admits never takes it."""
    calls = []
    real = tlin.xla_matmul
    monkeypatch.setattr(tlin, "xla_matmul",
                        lambda x, w: calls.append(x.shape[0]) or real(x, w))
    real_kernels = {k: getattr(tlin.gptq_cuda, k) for k in KERNELS}
    for shape, sym in KINDS:
        _, tq = _weight(shape, sym, seed=6)
        ln = torch.rand(tq.din) + 0.5
        _forbid(monkeypatch, KERNELS)
        for n in ROWS + [129, 480]:
            x = torch.randn(n, tq.din).to(torch.bfloat16)
            for mxu in (False, True):
                for norm in (None, (ln, EPS)):
                    assert not tlin.kernel_route(tq, n, mxu)
                    calls.clear()
                    tlin.apply_linear(tq, x, norm=norm, mxu_bf16=mxu)
                    assert calls == [n], (shape, sym, n, mxu)
    for k, fn in real_kernels.items():
        monkeypatch.setattr(tlin.gptq_cuda, k, fn)
    # a shape the kernels take keeps its kernel at every row count where
    # kernel_route admits it (the kernels' plain versions on the CPU)
    jq = jlin.quantize(jnp.asarray(np.random.default_rng(1).standard_normal(
        (256, 256)).astype(np.float32)), bits=8, group_size=128)
    tq = bridge.convert(jq)
    for n in (1, 64, 65, 128, 129):
        for mxu in (False, True):
            calls.clear()
            tlin.apply_linear(tq, torch.randn(n, 256), mxu_bf16=mxu)
            assert calls == ([] if tlin.kernel_route(tq, n, mxu) else [n])


def test_route_checks_tf32(monkeypatch):
    _, tq = _weight("int8 gs64", True, seed=3)
    x = torch.randn(11, tq.din)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        tlin.apply_linear(tq, x)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        tlin.apply_linear(tq, torch.randn(65, tq.din))
