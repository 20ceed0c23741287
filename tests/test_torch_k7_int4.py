"""Port parity of K7i4 (the bf16-operand mode of the packed-int4 Pallas
kernels) and of the bf16-operand route against the JAX package on the CPU.

* K7i4's plain version, plain and norm-fused, symmetric and with zero
  points, and K7's int8 zero-point case, against `gptq_pallas.gptq_matmul(
  ..., interpret=True, mxu_bf16=True)` with f32 x: within 1e-5 of
  sum |x * w| per output, the measure of test_k7_plain_matches_pallas. Both
  round the operands to bf16 and accumulate in f32, so they differ in
  summation order only. Three negative controls exceed ten times that
  limit: the -8 folded into the staged weight (signed-code rounding), f32
  operands, and an unrounded weight.
* The route: which products take bf16 operands, against the JAX auto
  route's decision (`mxu_bf16`, 129-1024 rows, `pallas_supported` and
  `batched_rows_ok`), and which plain version apply_linear runs.
* A slot-batched forward of a 2-layer float32 packed-int4 model with
  gptq_mxu_bf16 at 2 x 80 rows against the JAX forward with
  gptq_path="pallas": the same bf16-operand products, logits within 0.1 of
  each row's RMS (why no closer: the test's docstring).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.engine import kvcache as jkv
from hsd_tpu.models import transformer as jtr
from hsd_tpu.ops import gptq_pallas as jgp
from hsd_tpu.ops import linear as jlin
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import ModelConfig as TCfg
from hsd_tpu_torch.engine import kvcache as tkv
from hsd_tpu_torch.models import transformer as ttr
from hsd_tpu_torch.ops import gptq_cuda as G
from hsd_tpu_torch.ops import linear as tlin

torch.set_num_threads(2)
TOL = 1e-5          # of sum |x * w| per output


def _np(t):
    return t.detach().cpu().float().numpy()


def _jq(rng, din, dout, bits, gs, symmetric):
    w = rng.standard_normal((din, dout)).astype(np.float32)
    return jlin.quantize(jnp.asarray(w), bits=bits, group_size=gs,
                         symmetric=symmetric)


def _gap(y, want, mag):
    return float((np.abs(_np(y) - want) / mag).max())


CASES = [(ln, zeros) for ln in (False, True) for zeros in (False, True)
         if not (ln and zeros)]      # the fused norm takes symmetric weights


@pytest.mark.parametrize("ln,zeros", CASES)
@pytest.mark.parametrize("gs", [64, 128])
@pytest.mark.parametrize("n", [129, 160])
def test_k7i4_plain_matches_pallas(n, gs, ln, zeros):
    rng = np.random.default_rng(1000 + n + gs + 2 * ln + zeros)
    jq = _jq(rng, 512, 384, 4, gs, not zeros)
    x = rng.standard_normal((n, 512)).astype(np.float32)
    lnw = (rng.random(512) + 0.5).astype(np.float32)
    kw = dict(ln=jnp.asarray(lnw), ln_eps=1e-5) if ln else {}
    want = np.asarray(jgp.gptq_matmul(jnp.asarray(x), jq, interpret=True,
                                      mxu_bf16=True, **kw))
    tq = bridge.convert(jq)
    assert tq.packed_int4 and (tq.zeros is not None) == zeros
    tx = torch.from_numpy(x)
    tln = torch.from_numpy(lnw) if ln else None
    got = G.int4_matmul_bf16(tx, tq.qweight, tq.scales, tq.zeros, tln, 1e-5)
    xs = G._rms_f32(tx, tln, 1e-5) if ln else tx
    w = G.dequantize_int4(tq.qweight, tq.scales, tq.zeros)
    mag = _np(xs.abs() @ w.abs()) + 1e-9
    if ln:
        # the norm-fused form is the plain form on the f32 normed x ...
        assert torch.equal(got, G.int4_matmul_plain(xs, tq.qweight,
                                                    tq.scales,
                                                    bf16_operands=True))
        # ... and XLA's rsqrt is not correctly rounded: the inverse RMS
        # differs in its last bit, which flips the bf16 rounding of about
        # one normed activation in 1e5. Held to the limit on the normed x
        # of the Pallas kernel's own ops (the flips' exact contribution).
        xj = torch.from_numpy(np.array(_jax_normed(x, lnw, 1e-5)))
        flips = int((G._bf16_round(xj) != G._bf16_round(xs)).sum())
        assert flips <= 4, flips
        got = G.int4_matmul_plain(xj, tq.qweight, tq.scales,
                                  bf16_operands=True)
    assert _gap(got, want, mag) < TOL
    # the limit sees the mode: the -8 folded into the staged weight, f32
    # operands, or an unrounded weight each fail it tenfold
    signed = G._bf16_round(xs) @ G._bf16_round(w)
    unrounded = (G._bf16_round(xs) @ (G._nibbles(tq.qweight).reshape(
        -1, gs, 384) * tq.scales[:, None, :]).reshape(512, 384)
        - G._correction(xs, tq.scales, tq.zeros, 8.0))
    for control in (signed, xs @ w, unrounded):
        assert _gap(control, want, mag) > 10 * TOL


def _jax_normed(x, ln, eps):
    """x * rsqrt(mean(x^2) + eps) * ln by the ops of _kernel_int4_ln."""
    xf = jnp.asarray(x)
    r = jax.lax.rsqrt(jnp.mean(xf * xf, axis=1, keepdims=True) + eps)
    return xf * r * jnp.asarray(ln)[None, :]


@pytest.mark.parametrize("n", [129, 160])
def test_k7_int8_zeros_plain_matches_pallas(n):
    """K7 on an asymmetric int8 weight: bf16(x) @ bf16(code * scale), then
    the f32 zero-point correction on the unrounded x."""
    rng = np.random.default_rng(1100 + n)
    jq = _jq(rng, 512, 384, 8, 128, False)
    x = rng.standard_normal((n, 512)).astype(np.float32)
    want = np.asarray(jgp.gptq_matmul(jnp.asarray(x), jq, interpret=True,
                                      mxu_bf16=True))
    tq = bridge.convert(jq)
    tx = torch.from_numpy(x)
    got = G.int8_matmul_bf16(tx, tq.qweight, tq.scales, tq.zeros)
    w = G.dequantize_int8(tq.qweight, tq.scales, tq.zeros)
    mag = _np(tx.abs() @ w.abs()) + 1e-9
    assert _gap(got, want, mag) < TOL
    assert _gap(tx @ w, want, mag) > 10 * TOL
    assert _gap(G._bf16_round(tx) @ G._bf16_round(w), want, mag) > 10 * TOL


def test_fused_norm_takes_symmetric_weights_only():
    rng = np.random.default_rng(1200)
    tq = bridge.convert(_jq(rng, 256, 128, 4, 128, False))
    x = torch.randn(129, 256)
    with pytest.raises(ValueError, match="symmetric"):
        G.int4_matmul_bf16(x, tq.qweight, tq.scales, tq.zeros,
                           torch.ones(256), 1e-5)


# (label, din, dout, bits, group size, symmetric, the rows of ROUTE_ROWS
# that take bf16 operands with mxu_bf16): the small shapes run apply_linear
# too; the wide ones (a Llama-3.1-8B wdown width) only decide
ROUTE_ROWS = (128, 129, 480, 1024, 1025)
ROUTE_WEIGHTS = [
    ("int4 sym", 256, 256, 4, 128, True, (129, 480, 1024)),
    ("int4 asym", 256, 256, 4, 64, False, (129, 480, 1024)),
    ("int8 sym", 256, 256, 8, 128, True, (129, 480, 1024)),
    ("int8 asym", 256, 256, 8, 128, False, (129, 480, 1024)),
    ("int4 odd group count", 384, 256, 4, 128, True, ()),
    ("int8 ragged out", 256, 200, 8, 128, True, ()),
    ("int8 group of 64", 256, 256, 8, 64, True, ()),
    # batched_rows_ok: no out-block beside 1024 rows of a 7168-row in-block
    ("int8 wide din", 14336, 128, 8, 128, True, (129, 480)),
    ("int4 wide din", 14336, 128, 4, 128, True, (129, 480, 1024)),
]


def _route_weight(rng, din, dout, bits, gs, sym):
    """A JAX QuantizedLinear of the given layout (random codes)."""
    g = din // gs
    if bits == 4:
        codes = rng.integers(0, 256, size=(din // 2, dout)).astype(np.uint8)
    else:
        codes = rng.integers(-127, 128, size=(din, dout)).astype(np.int8)
    scales = (rng.random((g, dout)) * 1e-2 + 1e-3).astype(np.float32)
    zeros = None if sym else rng.standard_normal((g, dout)).astype(np.float32)
    return jlin.QuantizedLinear(qweight=jnp.asarray(codes),
                                scales=jnp.asarray(scales),
                                zeros=None if zeros is None
                                else jnp.asarray(zeros))


@pytest.mark.parametrize("weight", range(len(ROUTE_WEIGHTS)))
def test_bf16_route_matches_jax(weight):
    """The decision for each row count with mxu_bf16 on and off equals the
    JAX auto route's (`_use_pallas` on its device, mxu_bf16 set above 128
    rows: `pallas_supported and batched_rows_ok` up to 1024 rows); on the
    small shapes apply_linear then runs that plain version, with and
    without a norm (an asymmetric weight norms first and rounds)."""
    label, din, dout, bits, gs, sym, expect = ROUTE_WEIGHTS[weight]
    rng = np.random.default_rng(1300 + weight)
    jq = _route_weight(rng, din, dout, bits, gs, sym)
    tq = bridge.convert(jq)
    ln = torch.from_numpy((rng.random(din) + 0.5).astype(np.float32))
    plain = G.int4_matmul_plain if bits == 4 else G.int8_matmul_plain
    ln_plain = G.int4_ln_matmul_plain if bits == 4 else G.int8_ln_matmul_plain
    for n in ROUTE_ROWS:
        xj = jnp.zeros((n, din), jnp.float32)
        jax_bf16 = (128 < n <= 1024 and jgp.pallas_supported(xj, jq)
                    and jgp.batched_rows_ok(xj, jq))
        assert jax_bf16 == (n in expect), (label, n)
        for flag in (False, True):
            bf16 = tlin.bf16_route(tq, n, flag)
            assert bf16 == (flag and jax_bf16), (label, n, flag)
            if din > 512:
                continue
            x = torch.from_numpy(
                rng.standard_normal((n, din)).astype(np.float32))
            want = plain(x, tq.qweight, tq.scales, tq.zeros,
                         bf16_operands=bf16)
            assert torch.equal(tlin.apply_linear(tq, x, mxu_bf16=flag), want)
            if sym:
                want = ln_plain(x, tq.qweight, tq.scales, ln, 1e-5,
                                bf16_operands=bf16)
            else:
                want = plain(tlin.rms_norm(x, ln, 1e-5), tq.qweight,
                             tq.scales, tq.zeros, bf16_operands=bf16)
            assert torch.equal(tlin.apply_linear(tq, x, norm=(ln, 1e-5),
                                                 mxu_bf16=flag), want)


def _int4_params(jcfg):
    """Fused layers quantized to packed int4 (group 64), each weight scaled
    by din^-0.5 first so the residual stream stays near unit RMS."""
    p = jtr.fuse_params(jcfg, jtr.init_params(jcfg, jax.random.PRNGKey(4)))
    q = lambda w: jlin.quantize(w * w.shape[0] ** -0.5, bits=4, group_size=64,
                                symmetric=True)
    layers = dict(p.layers)
    for name in ("wqkv", "wo", "wgu", "wdown"):
        layers[name] = jax.vmap(q)(layers[name])
    return p._replace(layers=layers, lm_head=q(p.lm_head))


def test_slot_batched_int4_forward_matches_jax(monkeypatch):
    """Two slots of 80 tokens (160 rows) through a 2-layer float32
    packed-int4 model with gptq_mxu_bf16: every product of both forwards
    takes the bf16-operand mode (K7i4's plain version here, the Pallas
    kernel in interpret mode in JAX), and the logits agree within 0.1 of
    each row's RMS. Closer is not to be had: XLA's rsqrt is not correctly
    rounded, so a normed activation's bf16 rounding flips now and then
    (test_k7i4_plain_matches_pallas), and any such difference grows, through
    attention and the next products' bf16 roundings, to bf16 noise on
    every later activation."""
    jcfg = JCfg(vocab_size=256, hidden_size=256, intermediate_size=512,
                num_layers=2, num_heads=4, num_kv_heads=2,
                tie_word_embeddings=False, attention_bias=False,
                dtype=jnp.float32, gptq_path="pallas", gptq_mxu_bf16=True)
    jp = _int4_params(jcfg)
    tcfg = TCfg(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "rope_theta", "rms_norm_eps",
        "tie_word_embeddings", "attention_bias", "eos_token_id",
        "gptq_mxu_bf16")}, dtype=torch.float32)
    tp = bridge.params_from_jax(jp)
    jax_calls, port_calls = set(), set()
    jmatmul = jgp.gptq_matmul

    def record_jax(x, qw, **kw):
        jax_calls.add((x.shape[-1], qw.qweight.shape[-1], kw["mxu_bf16"],
                       kw.get("ln") is not None))
        return jmatmul(x, qw, **kw)

    def record_port(fn, bf16):
        def run(x, qweight, scales, *args):
            ln = args[1] if bf16 else (args[0] if len(args) == 2 else None)
            port_calls.add((x.shape[-1], qweight.shape[-1], bf16,
                            ln is not None))
            return fn(x, qweight, scales, *args)
        return run

    monkeypatch.setattr(jgp, "gptq_matmul", record_jax)
    for name, bf16 in (("int4_matmul_bf16", True), ("int4_matmul", False),
                       ("int4_ln_matmul", False)):
        monkeypatch.setattr(G, name, record_port(getattr(G, name), bf16))
    toks = np.random.default_rng(1400).integers(
        0, 256, size=(2, 80)).astype(np.int32)
    jl, _ = jtr.forward(jcfg, jp, jnp.asarray(toks),
                        jkv.init_cache(jcfg, 2, 96))
    tl, _ = ttr.forward(tcfg, tp, torch.from_numpy(toks).long(),
                        tkv.init_cache(tcfg, 2, 96, "cpu"))
    # wqkv and wgu with the norm fused, wo, wdown and the head without
    assert port_calls == jax_calls == {
        (256, 512, True, True), (256, 256, True, False),
        (256, 1024, True, True), (512, 256, True, False)}
    jl = np.asarray(jl)
    rms = np.sqrt(np.mean(jl ** 2, axis=-1, keepdims=True))
    assert (np.abs(_np(tl) - jl) / rms).max() < 0.1
