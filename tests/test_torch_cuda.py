"""The port's CUDA kernels on the card: each wrapper against its plain
version (K1-K8, K7i4; K1, K3, K4 and K5 at every row tiling of their
tensor-core kernel; K2 and K6, its products in one call, at 1-32 rows,
split and unsplit, with a ragged width; K7's pre-pass, and K7 at ragged
widths, both block heights and 1-4 k-slices a group; K7i4's pre-pass
with its group sums, and K7i4 at ragged widths and 1-4 k-slices a group),
a row's bits independent of the row count, the
dequantize-then-dot route above 128 rows and the XLA route on shapes no
kernel takes (no kernel, near the plain result), and greedy spec == AR
through the kernels. Marked `cuda`; each test skips when no card is present
(decided in a fixture, never at import). Run on the card with
`python -m pytest tests/test_torch_cuda.py -q -m cuda`.

Tolerance: bf16 outputs within 2^-7 of the output's max magnitude (two bf16
roundings); f32 outputs within 1e-4 of it (summation order only).
"""
import pytest
import torch

from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine import make_autoregressive, make_generate
from hsd_tpu_torch.eval.synthetic import init_quantized_params, quantize_draft
from hsd_tpu_torch.models.transformer import (fuse_params, init_params,
                                              rope_tables)
from hsd_tpu_torch.ops import flash_decode as FD
from hsd_tpu_torch.ops import gptq_cuda as G
from hsd_tpu_torch.ops import launch_counts, reset_launches
from hsd_tpu_torch.ops.linear import QuantizedLinear, apply_linear, apply_mlp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _q4(g, dev, din, dout):
    w = torch.empty((din // 2, dout), dtype=torch.uint8, device=dev)
    w.random_(0, 256, generator=g)
    s = torch.rand((din // 128, dout), generator=g, device=dev) * 1e-2 + 1e-3
    return w, s.to(torch.bfloat16)


def _close(got, want, dtype):
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [1, 2, 11, 40])
def test_kernels_match_plain(dev, dtype, n):
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn((n, 512), generator=g, device=dev).to(dtype)
    ln = torch.rand(512, generator=g, device=dev) + 0.5
    w, s = _q4(g, dev, 512, 640)
    _close(G.int4_ln_matmul(x, w, s, ln, 1e-6),
           G.int4_ln_matmul_plain(x, w, s, ln, 1e-6), dtype)
    _close(G.int4_matmul(x, w, s), G.int4_matmul_plain(x, w, s), dtype)
    w8 = torch.empty((512, 300), dtype=torch.int8, device=dev)
    w8.random_(-128, 128, generator=g)
    s8 = torch.rand((4, 300), generator=g, device=dev) * 1e-2
    z8 = torch.randn((4, 300), generator=g, device=dev)
    _close(G.int8_matmul(x, w8, s8, z8), G.int8_matmul_plain(x, w8, s8, z8),
           dtype)
    wo, so = _q4(g, dev, 512, 512)
    wgu, sg = _q4(g, dev, 512, 2048)
    wd, sd = _q4(g, dev, 1024, 512)
    res = torch.randn((n, 512), generator=g, device=dev).to(dtype)
    _close(G.attn_mlp_int4(x, res, wo, so, wgu, sg, wd, sd, ln, 1e-6),
           G.attn_mlp_int4_plain(x, res, wo, so, wgu, sg, wd, sd, ln, 1e-6),
           dtype)
    s8sym = (s8 + 1e-3).to(torch.bfloat16)
    _close(G.int8_ln_matmul(x, w8, s8sym, ln, 1e-6),
           G.int8_ln_matmul_plain(x, w8, s8sym, ln, 1e-6), dtype)


I8_ROWS = [1, 2, 8, 9, 16, 17, 64, 80, 128]


def _i8_case(dev, seed, din, dout, groups, zeros):
    g = torch.Generator(device=dev).manual_seed(seed)
    w8 = torch.empty((din, dout), dtype=torch.int8, device=dev)
    w8.random_(-128, 128, generator=g)
    s8 = torch.rand((groups, dout), generator=g, device=dev) * 1e-2 + 1e-3
    z8 = (torch.randn((groups, dout), generator=g, device=dev) * 40
          if zeros else None)
    return g, w8, s8, z8


@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("dout", [300, 384])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_tensor_core_matches_plain(dev, dtype, dout, zeros):
    """K4 (with and without zero points, bf16 and f32 scales) and K5 on the
    tensor-core kernel against their plain versions at every row count of
    the tiling (1-8, 9-16, 17-32, 33-64, 65-128 rows per block, and f32 at
    200 rows, two row blocks), ragged dout included; one launch a call."""
    g, w8, s8, z8 = _i8_case(dev, dout + 7 * zeros, 512, dout, 4, zeros)
    ln = torch.rand(512, generator=g, device=dev) + 0.5
    rows = I8_ROWS + ([200] if dtype == torch.float32 else [])
    for n in rows:
        x = torch.randn((n, 512), generator=g, device=dev).to(dtype)
        for s in (s8, s8.to(torch.bfloat16)):
            before = G.int8_matmul.launches
            _close(G.int8_matmul(x, w8, s, z8),
                   G.int8_matmul_plain(x, w8, s, z8), dtype)
            assert G.int8_matmul.launches == before + 1
            if not zeros:
                _close(G.int8_ln_matmul(x, w8, s, ln, 1e-6),
                       G.int8_ln_matmul_plain(x, w8, s, ln, 1e-6), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_row_bits_independent_of_row_count(dev, dtype):
    """A row's bits from K4 and K5 are the same at every row count, and
    with the input dimension split across blocks (896 x 896: 7 splits)."""
    g, w8, s8, z8 = _i8_case(dev, 11, 896, 896, 7, True)
    ln = torch.rand(896, generator=g, device=dev) + 0.5
    x = torch.randn((200, 896), generator=g, device=dev).to(dtype)
    calls = (lambda x: G.int8_matmul(x, w8, s8),
             lambda x: G.int8_matmul(x, w8, s8, z8),
             lambda x: G.int8_ln_matmul(x, w8, s8, ln, 1e-6))
    for call in calls:
        full = call(x[:128])
        for n in I8_ROWS:
            assert torch.equal(call(x[:n]), full[:n]), n
        if dtype == torch.float32:
            assert torch.equal(call(x)[:128], full)


def test_int8_tensor_core_raises_on_unsupported_shape(dev):
    g, w8, s8, _ = _i8_case(dev, 5, 512, 256, 8, False)   # groups of 64
    x = torch.randn((2, 512), generator=g, device=dev)
    with pytest.raises(RuntimeError, match="shape not supported"):
        G.int8_matmul(x, w8, s8)
    with pytest.raises(RuntimeError, match="shape not supported"):
        G.int8_ln_matmul(x, w8, s8, torch.ones(512, device=dev), 1e-6)
    _, w8, s8, _ = _i8_case(dev, 6, 512, 256, 4, False)
    off = torch.randn(2 * 512 + 1, generator=g, device=dev)[1:].view(2, 512)
    with pytest.raises(ValueError, match="aligned"):
        G.int8_matmul(off, w8, s8)
    with pytest.raises(ValueError):
        G.int8_matmul(x.to(torch.float16), w8, s8)


I4_ROWS = [1, 2, 7, 11, 16, 17, 63, 64, 121, 128]


def _i4_case(dev, seed, din, dout, zeros):
    g = torch.Generator(device=dev).manual_seed(seed)
    w, s = _q4(g, dev, din, dout)
    z = (torch.randn((din // 128, dout), generator=g, device=dev) * 3
         if zeros else None)
    ln = torch.rand(din, generator=g, device=dev) + 0.5
    return g, w, s, z, ln


@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("dout", [640, 1000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int4_tensor_core_matches_plain(dev, dtype, dout, zeros):
    """K1 and K3 (with and without zero points, bf16 and f32 scales) on the
    tensor-core kernel against their plain versions at every row tiling
    (1-8, 9-16, 17-32, 33-64 rows a block, and two blocks up to 128; 200
    rows, four blocks, only direct calls reach), ragged dout included; one
    launch a call."""
    g, w, s, z, ln = _i4_case(dev, dout + 7 * zeros, 1024, dout, zeros)
    for n in I4_ROWS + [200]:
        x = torch.randn((n, 1024), generator=g, device=dev).to(dtype)
        for sc in (s, s.float()):
            before = G.int4_matmul.launches
            _close(G.int4_matmul(x, w, sc, z),
                   G.int4_matmul_plain(x, w, sc, z), dtype)
            assert G.int4_matmul.launches == before + 1
            if not zeros:
                before = G.int4_ln_matmul.launches
                _close(G.int4_ln_matmul(x, w, sc, ln, 1e-6),
                       G.int4_ln_matmul_plain(x, w, sc, ln, 1e-6), dtype)
                assert G.int4_ln_matmul.launches == before + 1


@pytest.mark.parametrize("gs", [64, 192])
def test_int4_group_sizes_match_plain(dev, gs):
    """K1 and K3 at groups of 64 features (the smallest the Pallas kernel
    takes) and of 192, whose groups span three k-slices, so that the
    128-row splits of a 3072 x 256 weight (12 splits) end inside groups."""
    g = torch.Generator(device=dev).manual_seed(gs)
    din, dout = 3072, 256
    w = torch.empty((din // 2, dout), dtype=torch.uint8, device=dev)
    w.random_(0, 256, generator=g)
    s = (torch.rand((din // gs, dout), generator=g, device=dev) * 1e-2
         + 1e-3).to(torch.bfloat16)
    z = torch.randn((din // gs, dout), generator=g, device=dev) * 3
    ln = torch.rand(din, generator=g, device=dev) + 0.5
    for n in (1, 11, 40):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((n, din), generator=g, device=dev).to(dtype)
            _close(G.int4_matmul(x, w, s, z), G.int4_matmul_plain(x, w, s, z),
                   dtype)
            _close(G.int4_ln_matmul(x, w, s, ln, 1e-6),
                   G.int4_ln_matmul_plain(x, w, s, ln, 1e-6), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int4_row_bits_independent_of_row_count(dev, dtype):
    """A row's bits from K1 and K3 are the same at every row count, direct
    calls of 200 rows included, and with the input dimension split across
    blocks (1792 x 896: 7 splits)."""
    g, w, s, z, ln = _i4_case(dev, 12, 1792, 896, True)
    x = torch.randn((200, 1792), generator=g, device=dev).to(dtype)
    calls = (lambda x: G.int4_matmul(x, w, s),
             lambda x: G.int4_matmul(x, w, s, z),
             lambda x: G.int4_ln_matmul(x, w, s, ln, 1e-6))
    assert G.splits_for(896, 896, G._sm_count(dev.index or 0)) > 1
    for call in calls:
        full = call(x[:128])
        for n in I4_ROWS:
            assert torch.equal(call(x[:n]), full[:n]), n
        assert torch.equal(call(x)[:128], full)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dequant_route_above_128_rows(dev, dtype):
    """apply_linear at 129 and 693 rows without mxu_bf16 takes the
    dequantize-then-dot route: no kernel launches, and the result within
    the tolerance of the f32 plain version (bf16: the route rounds the
    normed x and the weight to bf16, as the reference does)."""
    g, w, s, z, ln = _i4_case(dev, 21, 1024, 640, True)
    w8 = torch.empty((1024, 384), dtype=torch.int8, device=dev)
    w8.random_(-127, 128, generator=g)
    s8 = torch.rand((8, 384), generator=g, device=dev) * 1e-2 + 1e-3
    cases = [(QuantizedLinear(w, s, None), True),
             (QuantizedLinear(w, s, z), False),
             (QuantizedLinear(w8, s8, None), True)]
    for n in (129, 693):
        x = torch.randn((n, 1024), generator=g, device=dev).to(dtype)
        for qw, norm in cases:
            plain = (G.int4_matmul_plain if qw.packed_int4
                     else G.int8_matmul_plain)
            reset_launches()
            got = apply_linear(qw, x, norm=(ln, 1e-6) if norm else None)
            assert not any(launch_counts().values()), launch_counts()
            xs = G._rms_f32(x, ln, 1e-6) if norm else x
            _close(got, plain(xs, qw.qweight, qw.scales, qw.zeros), dtype)


@pytest.mark.parametrize("n", [129, 200, 480])
@pytest.mark.parametrize("dout", [256, 300, 1000])
def test_k7_matches_plain(dev, n, dout):
    """K7 (bf16 tensor-core operands, bf16 activations) against its plain
    version, with and without the fused norm, ragged rows and columns
    included."""
    g = torch.Generator(device=dev).manual_seed(n + dout)
    x = torch.randn((n, 512), generator=g, device=dev).to(torch.bfloat16)
    ln = torch.rand(512, generator=g, device=dev) + 0.5
    w8 = torch.empty((512, dout), dtype=torch.int8, device=dev)
    w8.random_(-127, 128, generator=g)
    s8 = (torch.rand((4, dout), generator=g, device=dev) * 1e-2
          + 1e-3).to(torch.bfloat16)
    _close(G.int8_matmul_bf16(x, w8, s8),
           G.int8_matmul_plain(x, w8, s8, bf16_operands=True), torch.bfloat16)
    _close(G.int8_matmul_bf16(x, w8, s8, ln=ln, eps=1e-6),
           G.int8_ln_matmul_plain(x, w8, s8, ln, 1e-6, bf16_operands=True),
           torch.bfloat16)


@pytest.mark.parametrize("n", [129, 200, 480])
@pytest.mark.parametrize("dout", [256, 300, 1000])
def test_k7i4_matches_plain(dev, n, dout):
    """K7i4 (packed int4, bf16 tensor-core operands, bf16 activations)
    against its plain version: plain, with the fused norm, and with zero
    points; ragged rows and columns included."""
    g = torch.Generator(device=dev).manual_seed(7 * n + dout)
    x = torch.randn((n, 512), generator=g, device=dev).to(torch.bfloat16)
    ln = torch.rand(512, generator=g, device=dev) + 0.5
    w, s = _q4(g, dev, 512, dout)
    z = torch.randn((4, dout), generator=g, device=dev)
    before = G.int4_matmul_bf16.launches
    _close(G.int4_matmul_bf16(x, w, s),
           G.int4_matmul_plain(x, w, s, bf16_operands=True), torch.bfloat16)
    _close(G.int4_matmul_bf16(x, w, s, ln=ln, eps=1e-6),
           G.int4_ln_matmul_plain(x, w, s, ln, 1e-6, bf16_operands=True),
           torch.bfloat16)
    _close(G.int4_matmul_bf16(x, w, s, z),
           G.int4_matmul_plain(x, w, s, z, bf16_operands=True),
           torch.bfloat16)
    assert G.int4_matmul_bf16.launches == before + 3


@pytest.mark.parametrize("n", [129, 480])
def test_k7_int8_zeros_matches_plain(dev, n):
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn((n, 512), generator=g, device=dev).to(torch.bfloat16)
    w8 = torch.empty((512, 384), dtype=torch.int8, device=dev)
    w8.random_(-128, 128, generator=g)
    s8 = (torch.rand((4, 384), generator=g, device=dev) * 1e-2
          + 1e-3).to(torch.bfloat16)
    z8 = torch.randn((4, 384), generator=g, device=dev)
    _close(G.int8_matmul_bf16(x, w8, s8, z8),
           G.int8_matmul_plain(x, w8, s8, z8, bf16_operands=True),
           torch.bfloat16)


def _k7_case(g, dev, din, dout, groups, zeros, f32_scales=False):
    w8 = torch.empty((din, dout), dtype=torch.int8, device=dev)
    w8.random_(-128, 128, generator=g)
    s8 = torch.rand((groups, dout), generator=g, device=dev) * 1e-2 + 1e-3
    s8 = s8 if f32_scales else s8.to(torch.bfloat16)
    z8 = (torch.randn((groups, dout), generator=g, device=dev) * 4
          if zeros else None)
    return w8, s8, z8


@pytest.mark.parametrize("n", [129, 480, 1024])
def test_k7_stage_matches_plain(dev, n):
    """K7's pre-pass against k7_stage_plain: the inverse RMS within 2^-21
    (the summation order), xn = bf16((x * inv) * ln) bit for bit from the
    kernel's own inv, and within one bf16 step of the plain xn."""
    g = torch.Generator(device=dev).manual_seed(11 + n)
    x = torch.randn((n, 4096), generator=g, device=dev).to(torch.bfloat16)
    ln = torch.rand(4096, generator=g, device=dev) + 0.5
    inv, xn = G.k7_stage(x, ln, 1e-5)
    pinv, pxn = G.k7_stage_plain(x, ln, 1e-5)
    assert ((inv - pinv).abs() <= 2.0 ** -21 * pinv).all()
    assert torch.equal(xn, ((x.float() * inv[:, None]) * ln).to(torch.bfloat16))
    step = 2.0 ** (torch.floor(torch.log2(pxn.float().abs())) - 7)
    assert ((xn.float() - pxn.float()).abs() <= step).all()


@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("dout", [300, 1001])
@pytest.mark.parametrize("n", [129, 480, 1024])
def test_k7_ragged_matches_plain(dev, n, dout, zeros):
    """K7 against its plain version at a dout that is not a multiple of 16
    (4-byte weight copies) and one that is not a multiple of 4 (byte
    copies), with and without zero points (f32 scales with them), and with
    the fused norm where the weight is symmetric; one launch a call."""
    g = torch.Generator(device=dev).manual_seed(3 * n + dout + int(zeros))
    x = torch.randn((n, 1024), generator=g, device=dev).to(torch.bfloat16)
    ln = torch.rand(1024, generator=g, device=dev) + 0.5
    w8, s8, z8 = _k7_case(g, dev, 1024, dout, 8, zeros, f32_scales=zeros)
    before = G.int8_matmul_bf16.launches
    _close(G.int8_matmul_bf16(x, w8, s8, z8),
           G.int8_matmul_plain(x, w8, s8, z8, bf16_operands=True),
           torch.bfloat16)
    calls = 1
    if not zeros:
        _close(G.int8_matmul_bf16(x, w8, s8, ln=ln, eps=1e-6),
               G.int8_ln_matmul_plain(x, w8, s8, ln, 1e-6,
                                      bf16_operands=True), torch.bfloat16)
        calls += 1
    assert G.int8_matmul_bf16.launches == before + calls


@pytest.mark.parametrize("gs", [64, 128, 256])
def test_k7_row_bits_across_rows_and_heights(dev, gs):
    """A row's K7 bits at 129, 480 and 1024 rows, for groups of one, two
    and four k-slices: plain, with the fused norm, and with zero points;
    and the same with 128- and 256-row blocks (zero points: 128 only)."""
    g = torch.Generator(device=dev).manual_seed(gs)
    x = torch.randn((1024, 1024), generator=g, device=dev).to(torch.bfloat16)
    ln = torch.rand(1024, generator=g, device=dev) + 0.5
    w8, s8, z8 = _k7_case(g, dev, 1024, 896, 1024 // gs, True)
    for kw in ({}, {"ln": ln, "eps": 1e-6}, {"zeros": z8}):
        full = G.int8_matmul_bf16(x, w8, s8, **kw)
        for n in (129, 480):
            assert torch.equal(G.int8_matmul_bf16(x[:n], w8, s8, **kw),
                               full[:n]), (n, kw.keys())
        if "zeros" in kw:       # zero points take 128-row blocks only
            with pytest.raises(RuntimeError, match="shape not supported"):
                G._k7(x, w8, s8, z8, None, 0.0, block_rows=256)
            continue
        for n in (129, 480, 1024):
            tall = G._k7(x[:n], w8, s8, None, kw.get("ln"), kw.get("eps", 0.0),
                         block_rows=256)
            assert torch.equal(G._k7(x[:n], w8, s8, None, kw.get("ln"),
                                     kw.get("eps", 0.0), block_rows=128),
                               tall), (n, kw.keys())
            assert torch.equal(tall, full[:n]), (n, kw.keys())


def test_k7i4_row_bits_independent_of_row_count(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((480, 1024), generator=g, device=dev).to(torch.bfloat16)
    ln = torch.rand(1024, generator=g, device=dev) + 0.5
    w, s = _q4(g, dev, 1024, 896)
    z = torch.randn((8, 896), generator=g, device=dev)
    for kw in ({}, {"ln": ln, "eps": 1e-6}, {"zeros": z}):
        full = G.int4_matmul_bf16(x, w, s, **kw)
        for n in (129, 300):
            assert torch.equal(G.int4_matmul_bf16(x[:n], w, s, **kw),
                               full[:n]), kw.keys()


def _k7i4_case(g, dev, din, dout, gs, zeros, f32_scales=False):
    w = torch.empty((din // 2, dout), dtype=torch.uint8, device=dev)
    w.random_(0, 256, generator=g)
    s = torch.rand((din // gs, dout), generator=g, device=dev) * 1e-2 + 1e-3
    s = s if f32_scales else s.to(torch.bfloat16)
    z = (torch.randn((din // gs, dout), generator=g, device=dev) * 3
         if zeros else None)
    return w, s, z


@pytest.mark.parametrize("f32_scales", [False, True])
@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("dout", [300, 1001])
def test_k7i4_ragged_matches_plain(dev, dout, zeros, f32_scales):
    """K7i4 against its plain version at a dout that is not a multiple of
    16 (4-byte weight copies) and one that is not a multiple of 4 (byte
    copies), with and without zero points, with f32 and bf16 scales, and
    with the fused norm where the weight is symmetric; 129, 480 and 1024
    rows; one launch a call."""
    g = torch.Generator(device=dev).manual_seed(dout + 2 * zeros + f32_scales)
    ln = torch.rand(1024, generator=g, device=dev) + 0.5
    w, s, z = _k7i4_case(g, dev, 1024, dout, 128, zeros, f32_scales)
    for n in (129, 480, 1024):
        x = torch.randn((n, 1024), generator=g, device=dev).to(torch.bfloat16)
        before = G.int4_matmul_bf16.launches
        _close(G.int4_matmul_bf16(x, w, s, z),
               G.int4_matmul_plain(x, w, s, z, bf16_operands=True),
               torch.bfloat16)
        calls = 1
        if not zeros:
            _close(G.int4_matmul_bf16(x, w, s, ln=ln, eps=1e-6),
                   G.int4_ln_matmul_plain(x, w, s, ln, 1e-6,
                                          bf16_operands=True), torch.bfloat16)
            calls += 1
        assert G.int4_matmul_bf16.launches == before + calls


@pytest.mark.parametrize("gs", [64, 128, 256])
def test_k7i4_row_bits_across_rows(dev, gs):
    """A row's K7i4 bits at 129, 480 and 1024 rows, for groups of one, two
    and four k-slices: plain, with the fused norm, and with zero points;
    a 256-row block is refused (a packed weight always has a correction)."""
    g = torch.Generator(device=dev).manual_seed(100 + gs)
    x = torch.randn((1024, 1024), generator=g, device=dev).to(torch.bfloat16)
    ln = torch.rand(1024, generator=g, device=dev) + 0.5
    w, s, z = _k7i4_case(g, dev, 1024, 896, gs, True)
    for kw in ({}, {"ln": ln, "eps": 1e-6}, {"zeros": z}):
        full = G.int4_matmul_bf16(x, w, s, **kw)
        for n in (129, 480):
            assert torch.equal(G.int4_matmul_bf16(x[:n], w, s, **kw),
                               full[:n]), (n, kw.keys())
    with pytest.raises(RuntimeError, match="shape not supported"):
        G._k7(x, w, s, None, None, 0.0, block_rows=256)


@pytest.mark.parametrize("gs", [64, 128])
@pytest.mark.parametrize("n", [129, 480, 1024])
def test_k7i4_stage_matches_plain(dev, n, gs):
    """K7i4's pre-pass against k7_stage_plain: the inverse RMS within 2^-21,
    xn = bf16((x * inv) * ln) bit for bit from the kernel's own inv, and
    the group sums xg of the unrounded normed rows within 1e-6 of their
    absolute sums of the same sums on that inv (summation order), and of
    the plain version's (its inv) within 1e-5."""
    g = torch.Generator(device=dev).manual_seed(31 + n + gs)
    x = torch.randn((n, 4096), generator=g, device=dev).to(torch.bfloat16)
    ln = torch.rand(4096, generator=g, device=dev) + 0.5
    inv, xn, xg = G.k7_stage(x, ln, 1e-5, groups=4096 // gs)
    pinv, pxn, pxg = G.k7_stage_plain(x, ln, 1e-5, groups=4096 // gs)
    assert ((inv - pinv).abs() <= 2.0 ** -21 * pinv).all()
    xs = (x.float() * inv[:, None]) * ln
    assert torch.equal(xn, xs.to(torch.bfloat16))
    grouped = xs.reshape(n, -1, gs)
    mag = grouped.abs().sum(-1)
    assert ((xg - grouped.sum(-1)).abs() <= 1e-6 * mag).all()
    assert ((xg - pxg).abs() <= 1e-5 * mag).all()


def test_xla_route_on_unsupported_shapes(dev):
    """apply_linear at most 128 rows on shapes no kernel takes (int8 groups
    of 64 rows, a packed weight of out width 192) takes the reference's XLA
    route (grouped f32 partials up to 64 rows, dequantize-then-dot above):
    no kernel launches, and the result within the tolerance of the f32
    plain version."""
    g = torch.Generator(device=dev).manual_seed(41)
    w8 = torch.empty((512, 256), dtype=torch.int8, device=dev)
    w8.random_(-127, 128, generator=g)
    s8 = torch.rand((8, 256), generator=g, device=dev) * 1e-2 + 1e-3
    z8 = torch.randn((8, 256), generator=g, device=dev) * 4
    w4, s4, z4 = _k7i4_case(g, dev, 512, 192, 128, True, f32_scales=True)
    ln = torch.rand(512, generator=g, device=dev) + 0.5
    cases = [QuantizedLinear(w8, s8, None), QuantizedLinear(w8, s8, z8),
             QuantizedLinear(w4, s4, None), QuantizedLinear(w4, s4, z4)]
    for n in (1, 11, 64, 65, 128):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((n, 512), generator=g, device=dev).to(dtype)
            for qw in cases:
                plain = (G.int4_matmul_plain if qw.packed_int4
                         else G.int8_matmul_plain)
                for norm in (None, (ln, 1e-6)):
                    reset_launches()
                    got = apply_linear(qw, x, norm=norm, mxu_bf16=True)
                    assert not any(launch_counts().values()), launch_counts()
                    xs = G._rms_f32(x, ln, 1e-6) if norm else x
                    _close(got, plain(xs, qw.qweight, qw.scales, qw.zeros),
                           dtype)


def test_row_bits_independent_of_row_count(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((33, 1024), generator=g, device=dev).to(torch.bfloat16)
    ln = torch.rand(1024, generator=g, device=dev) + 0.5
    w, s = _q4(g, dev, 1024, 896)
    full = G.int4_ln_matmul(x, w, s, ln, 1e-6)
    for n in (1, 2, 5, 11, 16, 17):
        assert torch.equal(G.int4_ln_matmul(x[:n], w, s, ln, 1e-6), full[:n])
    w8 = torch.empty((1024, 896), dtype=torch.int8, device=dev)
    w8.random_(-127, 128, generator=g)
    full = G.int8_ln_matmul(x, w8, s, ln, 1e-6)
    for n in (1, 11, 17):
        assert torch.equal(G.int8_ln_matmul(x[:n], w8, s, ln, 1e-6), full[:n])
    xb = torch.randn((480, 1024), generator=g, device=dev).to(torch.bfloat16)
    full = G.int8_matmul_bf16(xb, w8, s, ln=ln, eps=1e-6)
    for n in (129, 300):
        assert torch.equal(G.int8_matmul_bf16(xb[:n], w8, s, ln=ln, eps=1e-6),
                           full[:n])


def test_wrappers_raise_on_bad_input(dev):
    w, s = _q4(torch.Generator(device=dev).manual_seed(1), dev, 512, 256)
    x = torch.randn((2, 512), device=dev)
    with pytest.raises(ValueError):
        G.int4_matmul(x.to(torch.float16), w, s)
    with pytest.raises(ValueError):
        G.int4_matmul(x[:, :256], w, s)
    odd, so = _q4(torch.Generator(device=dev).manual_seed(2), dev, 192, 256)
    with pytest.raises(RuntimeError, match="shape not supported"):
        G.int4_matmul(torch.randn((2, 192), device=dev), odd, so)
    w8 = torch.zeros((512, 256), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):          # K7 takes bf16 activations only
        G.int8_matmul_bf16(torch.randn((129, 512), device=dev), w8, s)
    with pytest.raises(ValueError):          # and so does K7i4
        G.int4_matmul_bf16(torch.randn((129, 512), device=dev), w, s)
    with pytest.raises(ValueError, match="symmetric"):
        G.int4_matmul_bf16(torch.randn((129, 512), device=dev).to(
            torch.bfloat16), w, s, torch.zeros((4, 256), device=dev),
            torch.ones(512, device=dev), 1e-6)
    xb = torch.randn((129, 384), device=dev).to(torch.bfloat16)
    w3, s3 = _q4(torch.Generator(device=dev).manual_seed(3), dev, 384, 256)
    with pytest.raises(RuntimeError, match="shape not supported"):
        G.int4_matmul_bf16(xb, w3, s3)      # K7i4: an odd group count
    with pytest.raises(ValueError):          # a weight of other rows
        G.int4_matmul_bf16(xb, w, s)
    with pytest.raises(ValueError, match="aligned"):
        off = torch.randn((129 * 512 + 1,), device=dev).to(torch.bfloat16)
        G.int4_matmul_bf16(off[1:].view(129, 512), w, s)


def test_greedy_spec_equals_ar_through_kernels(dev):
    cfg = ModelConfig.tiny(vocab_size=512, hidden_size=256,
                           intermediate_size=512, dtype=torch.float32,
                           eos_token_id=10**9)
    draft = quantize_draft(cfg, fuse_params(cfg, init_params(cfg, 5, dev)))
    target = init_quantized_params(cfg, seed=6, device=dev)
    eng = EngineConfig(verifier=VerifierConfig(method="greedy", gamma=4),
                       max_new_tokens=32, temperature=0.0)
    prompt = (torch.arange(16, device=dev) % 300) + 3
    reset_launches()
    res = make_generate(cfg, cfg, eng)(draft, target, prompt, 12, None)
    toks, length = make_autoregressive(cfg, eng)(target, prompt, 12, None)
    counts = launch_counts()
    assert min(counts[k] for k in ("K1", "K2", "K3", "K4")) > 0, counts
    assert res.tokens[16:res.length].tolist() == toks[16:length].tolist()


@pytest.mark.parametrize("n", [1, 11])
def test_k6_matches_plain(dev, n):
    """K6 reached the way a model reaches it: apply_mlp on layer-stacked
    weights with a layer index, one launch, against the plain version."""
    g = torch.Generator(device=dev).manual_seed(40 + n)
    x = torch.randn((n, 512), generator=g, device=dev).to(torch.bfloat16)
    ln = torch.rand(512, generator=g, device=dev) + 0.5
    wgu = QuantizedLinear(*(torch.stack(t) for t in zip(
        *[_q4(g, dev, 512, 2048) for _ in range(2)])), None)
    wd = QuantizedLinear(*(torch.stack(t) for t in zip(
        *[_q4(g, dev, 1024, 512) for _ in range(2)])), None)
    before = G.mlp_int4.launches
    got = apply_mlp(wgu, wd, x, ln, 1e-6, layer=1)
    assert G.mlp_int4.launches == before + 1
    _close(got, G.mlp_int4_plain(x, wgu.qweight[1], wgu.scales[1],
                                 wd.qweight[1], wd.scales[1], ln, 1e-6),
           torch.bfloat16)


TAIL_ROWS = [1, 2, 7, 11, 16, 17, 32]


def _tail_case(dev, seed, d, f, dout, dtype, n=32):
    """Weights of a tail (wo [d, d], wgu [d, 2f], wdown [f, dout]) and
    inputs of n rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ws = [_q4(g, dev, d, d), _q4(g, dev, d, 2 * f), _q4(g, dev, f, dout)]
    x, res = (torch.randn((n, d), generator=g, device=dev).to(dtype)
              for _ in range(2))
    ln = torch.rand(d, generator=g, device=dev) + 0.5
    return ws, x, res, ln


def _tail_call(kernel, ws, x, res, ln, plain=False):
    (wo, so), (wgu, sg), (wd, sd) = ws
    if kernel == "K2":
        fn = G.attn_mlp_int4_plain if plain else G.attn_mlp_int4
        return fn(x, res, wo, so, wgu, sg, wd, sd, ln, 1e-6)
    fn = G.mlp_int4_plain if plain else G.mlp_int4
    return fn(x, wgu, sg, wd, sd, ln, 1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", TAIL_ROWS)
@pytest.mark.parametrize("kernel", ["K2", "K6"])
def test_tail_matches_plain(dev, kernel, n, dtype):
    """K2 and K6 against their plain versions; every product split (wo 2,
    wgu 2, wdown 4 on an H100); only the kernel's own counter moves."""
    ws, x, res, ln = _tail_case(dev, 50 + n, 512, 1024, 512, dtype, n)
    reset_launches()
    got = _tail_call(kernel, ws, x, res, ln)
    counts = launch_counts()
    assert counts[kernel] == 1 and sum(counts.values()) == 1, counts
    assert got.dtype == dtype and got.shape == (n, 512)
    _close(got, _tail_call(kernel, ws, x, res, ln, plain=True), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["K2", "K6"])
def test_tail_unsplit_and_ragged_match_plain(dev, kernel, dtype):
    """wo and wgu with one split each (the product's single partial in the
    workspace), and K6 with a ragged output width."""
    sms = G._sm_count(dev.index or 0)
    ws, x, res, ln = _tail_case(dev, 60, 256, 512, 256, dtype, 11)
    assert [G.splits_for(w.shape[0], w.shape[1], sms)
            for w, _ in ws[:2]] == [1, 1]
    _close(_tail_call(kernel, ws, x, res, ln),
           _tail_call(kernel, ws, x, res, ln, plain=True), dtype)
    if kernel == "K6":
        ws, x, res, ln = _tail_case(dev, 61, 512, 1024, 1000, dtype, 7)
        got = _tail_call(kernel, ws, x, res, ln)
        assert got.shape == (7, 1000)
        _close(got, _tail_call(kernel, ws, x, res, ln, plain=True), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["K2", "K6"])
def test_tail_row_bits_independent_of_row_count(dev, kernel, dtype):
    for d, f in ((512, 1024), (256, 512)):
        ws, x, res, ln = _tail_case(dev, 70 + d, d, f, d, dtype)
        full = _tail_call(kernel, ws, x, res, ln)
        for n in TAIL_ROWS[:-1]:
            assert torch.equal(_tail_call(kernel, ws, x[:n], res[:n], ln),
                               full[:n]), (d, n)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["K2", "K6"])
def test_tail_at_slot_pool_rows(dev, kernel, dtype):
    """A slot pool routes on one slot's rows (ops.linear.route_rows) and
    hands K2 / K6 every slot's rows at once: 48, 88 and 96 rows (8 slots of
    6 and 11 rows, 3 of 32) against the plain version, each row's bits
    those of a 32-row call."""
    ws, x, res, ln = _tail_case(dev, 80, 512, 1024, 512, dtype, 96)
    full = _tail_call(kernel, ws, x, res, ln)
    _close(full, _tail_call(kernel, ws, x, res, ln, plain=True), dtype)
    for n in (32, 48, 88):
        assert torch.equal(_tail_call(kernel, ws, x[:n], res[:n], ln),
                           full[:n]), n


def _attention_case(dev, dtype, T, H, Hkv, d, S, kv_len, start, bias, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((T, H, d), generator=g, device=dev) * 2).to(dtype)
    k = torch.randn((S, Hkv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((S, Hkv, d), generator=g, device=dev).to(dtype)
    q_index = kv_len + torch.arange(T, device=dev)
    st = torch.tensor([start], device=dev)
    ab = None
    if bias:        # a trie mask: node i attends to its ancestor chain
        anc = torch.rand((T, T), generator=g, device=dev) < 0.6
        anc = torch.tril(anc) | torch.eye(T, dtype=torch.bool, device=dev)
        ab = torch.where(anc, 0.0, -1e30)
    cos2, sin2 = rope_tables((q_index - start)[None], d, 1e6)
    return q, k, v, q_index, st, ab, (cos2[0, :, 0], sin2[0, :, 0])


K8_CASES = [(1, 14, 2, 64, 204, 150, 3, False),      # 0.5B draft step
            (11, 40, 8, 128, 204, 150, 0, False),    # 14B verify
            (60, 32, 8, 128, 189, 100, 0, True),     # EAGLE tree
            (2, 8, 2, 64, 1000, 998, 5, True),
            (11, 40, 8, 128, 4192, 4100, 0, False),  # long context
            (64, 32, 8, 128, 189, 0, 0, True),       # EAGLE prefill: 4 row tiles
            (128, 8, 2, 64, 300, 160, 0, False),     # the gate's largest T
            (3, 8, 2, 128, 1000, 990, 37, False),    # ragged S, start mid-tile
            (2, 8, 2, 64, 40, 30, 0, True)]          # one chunk: a cluster of one


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", range(len(K8_CASES)))
@pytest.mark.parametrize("fused_rope", [False, True])
def test_k8_matches_plain(dev, dtype, case, fused_rope):
    T, H, Hkv, d, S, kv_len, start, bias = K8_CASES[case]
    q, k, v, qi, st, ab, rope = _attention_case(dev, dtype, T, H, Hkv, d, S,
                                                kv_len, start, bias, case)
    rope = rope if fused_rope else None
    before = FD.flash_decode.launches
    got = FD.flash_decode(q, k, v, qi, st, kv_len, ab, rope)
    assert FD.flash_decode.launches == before + 1
    want = FD.flash_core_plain(q, k, v, qi, st, kv_len, ab, rope).to(dtype)
    assert got.shape == want.shape and got.dtype == dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("fused_rope", [False, True])
def test_k8_row_bits_independent_of_t(dev, fused_rope):
    T, H, Hkv, d, S, kv_len = 11, 40, 8, 128, 1200, 1100
    q, k, v, qi, st, _, rope = _attention_case(dev, torch.bfloat16, T, H,
                                               Hkv, d, S, kv_len, 0, False, 9)
    full = FD.flash_decode(q, k, v, qi, st, kv_len, None,
                           rope if fused_rope else None)
    for t in (0, 5, 10):
        one = FD.flash_decode(
            q[t:t + 1], k, v, qi[t:t + 1], st, kv_len + t, None,
            (rope[0][t:t + 1], rope[1][t:t + 1]) if fused_rope else None)
        assert torch.equal(one, full[t:t + 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8_fully_masked_row_is_zero(dev, dtype):
    q, k, v, _, st, _, _ = _attention_case(dev, dtype, 2, 4, 2, 64,
                                           128, 40, 8, False, 3)
    qi = torch.tensor([40, 6], device=dev)
    out = FD.flash_decode(q, k, v, qi, st, 40)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    assert out[0].abs().max() > 0.1


def test_k8_repeat_call_same_bits(dev):
    """Two calls at different shapes, then the first again: the same bits
    (nothing of a call carries over to the next)."""
    a = _attention_case(dev, torch.bfloat16, 11, 40, 8, 128, 1200, 1100, 0,
                        False, 21)
    b = _attention_case(dev, torch.bfloat16, 60, 32, 8, 128, 189, 100, 0,
                        True, 22)
    first = FD.flash_decode(*a[:5], 1100, None, a[6])
    FD.flash_decode(*b[:5], 100, b[5])
    again = FD.flash_decode(*a[:5], 1100, None, a[6])
    assert torch.equal(first, again)


def _moe_target(dev, dtype):
    cfg = ModelConfig.tiny_moe(vocab_size=512, hidden_size=512,
                               intermediate_size=1024, num_heads=4,
                               num_kv_heads=2, num_experts=8, dtype=dtype)
    return cfg, init_quantized_params(cfg, seed=3, bits=4, device=dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_row_bits_independent_of_row_count(dev, dtype):
    """A row's router logits, top-k and _moe_ffn output are the same bits
    at 1, 11 and 64 rows (K3 for the 3 * 8 expert products)."""
    from hsd_tpu_torch.models.transformer import (_moe_ffn, moe_params,
                                                  moe_route)
    cfg, p = _moe_target(dev, dtype)
    lp = moe_params(p.layers, 0)
    g = torch.Generator(device=dev).manual_seed(5)
    h = torch.randn((64, 512), generator=g, device=dev).to(dtype)
    reset_launches()
    full = moe_route(cfg, lp["gate"], h)
    out = _moe_ffn(cfg, lp, h[None])[0]
    assert launch_counts()["K3"] == 24
    for n in (1, 11):
        part = moe_route(cfg, lp["gate"], h[-n:])
        for a, b in zip(part, full):
            assert torch.equal(a, b[-n:])
        assert torch.equal(_moe_ffn(cfg, lp, h[None, -n:])[0], out[-n:])


def test_k3_on_an_expert_view_matches_plain(dev):
    """K3 on expert e of layer l of a 4-D [L, E, in/2, out] stack, taken as
    views, against its plain version, with zero points and a perm."""
    _, p = _moe_target(dev, torch.bfloat16)
    w = p.layers["wdown"]
    g = torch.Generator(device=dev).manual_seed(6)
    zeros = torch.randn(w.scales.shape, generator=g, device=dev)
    perm = torch.stack([torch.stack([torch.randperm(1024, generator=g,
                                                    device=dev)
                                     for _ in range(8)]) for _ in range(2)])
    wz = w._replace(zeros=zeros, perm=perm)
    x = torch.randn((11, 1024), generator=g, device=dev).to(torch.bfloat16)
    for l, e in ((0, 0), (1, 5)):
        v = wz.layer(l).layer(e)
        assert v.qweight.data_ptr() == w.qweight[l, e].data_ptr()
        assert torch.equal(v.perm, perm[l, e])
        before = launch_counts()["K3"]
        got = apply_linear(v, x)
        assert launch_counts()["K3"] == before + 1
        xp = x.index_select(-1, perm[l, e])
        _close(got, G.int4_matmul_plain(xp, v.qweight, v.scales, v.zeros),
               torch.bfloat16)
