"""The port's CUDA kernels on the card: each wrapper against its plain
version, a row's bits independent of the row count, and greedy spec == AR
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
from hsd_tpu_torch.models.transformer import fuse_params, init_params
from hsd_tpu_torch.ops import gptq_cuda as G

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
    _close(G.int8_matmul_bf16(x, w8, s8, ln, 1e-6),
           G.int8_ln_matmul_plain(x, w8, s8, ln, 1e-6, bf16_operands=True),
           torch.bfloat16)


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
    full = G.int8_matmul_bf16(xb, w8, s, ln, 1e-6)
    for n in (129, 300):
        assert torch.equal(G.int8_matmul_bf16(xb[:n], w8, s, ln, 1e-6),
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


def test_greedy_spec_equals_ar_through_kernels(dev):
    cfg = ModelConfig.tiny(vocab_size=512, hidden_size=256,
                           intermediate_size=512, dtype=torch.float32,
                           eos_token_id=10**9)
    draft = quantize_draft(cfg, fuse_params(cfg, init_params(cfg, 5, dev)))
    target = init_quantized_params(cfg, seed=6, device=dev)
    eng = EngineConfig(verifier=VerifierConfig(method="greedy", gamma=4),
                       max_new_tokens=32, temperature=0.0)
    prompt = (torch.arange(16, device=dev) % 300) + 3
    G.reset_launches()
    res = make_generate(cfg, cfg, eng)(draft, target, prompt, 12, None)
    toks, length = make_autoregressive(cfg, eng)(target, prompt, 12, None)
    counts = G.launch_counts()
    assert min(counts[k] for k in ("K1", "K2", "K3", "K4")) > 0, counts
    assert res.tokens[16:res.length].tolist() == toks[16:length].tolist()
