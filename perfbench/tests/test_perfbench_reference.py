"""The plain reference against the program's forward on a tiny coupled
pair on the CPU in float32: each trunk (the int4 target, dense and MoE,
the bf16 small trunk and the int8 draft, symmetric and asymmetric) over a
whole sequence,
and a prefill then per-row decode steps through the cache as the slot pool
runs them. Float32 on both sides: they differ only in the order of sums.
Also the int8 codes' convention against the program's dequantize, and the
reference verifier against the program's HSD verifier."""
import pytest
import torch

from hsd_tpu_torch.engine.kvcache import init_cache
from hsd_tpu_torch.models import transformer
from hsd_tpu_torch.ops.linear import QuantizedLinear, dequantize
from hsd_tpu_torch.verify import verify

from perfbench.harness import coupled, weights
from perfbench.reference import model as ref
from perfbench.reference import verify as rverify

import tinybench

TOL = 2e-4     # of each row's logit spread; f32 on both sides


def pair(moe: bool):
    spec = dict(tinybench.MOE if moe else tinybench.CONFIG,
                served_dtype="float32")
    spec["draft"] = dict(spec["draft"], served_dtype="float32")
    return coupled.build(spec, 2 ** 31 + 1, "cpu", 1)


def port_trunk(served, name):
    if name == "big":
        return served.cfg_target, served.params_target.big
    if name == "small":
        return served.cfg_draft, served.params_target.small
    return served.cfg_draft, served.params_draft


@pytest.mark.parametrize("name,moe", [("big", False), ("big", True),
                                      ("small", False), ("draft", False),
                                      ("draft", True)])
def test_whole_sequence_and_cached_decode(name, moe):
    served = pair(moe)
    cfg, params = port_trunk(served, name)
    g = torch.Generator().manual_seed(5)
    seq = torch.randint(10, 500, (24,), generator=g)
    want = ref.logits(served.shapes[name], served.raw[name], [seq.tolist()],
                      [list(range(24))], device="cpu")[0]
    spread = want.std(-1, keepdim=True)
    cache = init_cache(cfg, 1, 40, "cpu")
    got, _ = transformer.forward(cfg, params, seq[None], cache)
    assert ((got[0] - want).abs() / spread).max() < TOL
    # a prefill of 16, then 8 steps at per-row frontiers (the pool's path)
    cache = init_cache(cfg, 1, 40, "cpu")
    _, cache = transformer.forward(cfg, params, seq[None, :16], cache,
                                   skip_head=True)
    for t in range(16, 24):
        step, cache = transformer.forward(
            cfg, params, seq[None, t:t + 1], cache,
            lengths=torch.tensor([t]))
        err = ((step[0, 0] - want[t]).abs() / spread[t]).max()
        assert err < TOL, (t, float(err))


def test_fp8_control_is_far_from_float32():
    served = pair(False)
    seq = list(range(20, 44))
    f32 = ref.logits(served.shapes["big"], served.raw["big"], [seq],
                     [range(24)], device="cpu")[0]
    low = ref.logits(served.shapes["big"], served.raw["big"], [seq],
                     [range(24)], precision="fp8", device="cpu")[0]
    assert float(ref.rel_err(low, f32).median()) > 50 * TOL


@pytest.mark.parametrize("sym", [False, True], ids=["asym", "sym"])
def test_int8_codes_dequantize_as_the_program_reads_them(sym):
    w = torch.randn((3, 256, 64), generator=torch.Generator().manual_seed(1))
    quantize = weights.quantize_sym8 if sym else weights.quantize_asym8
    raw = quantize(w.to(torch.bfloat16))
    for l in range(3):
        zeros = None if sym else raw["zeros"][l]
        mine = ref.dequant({"codes": raw["codes"][l],
                            "scales": raw["scales"][l],
                            "zeros": zeros, "bits": 8})
        port = dequantize(QuantizedLinear(raw["codes"][l], raw["scales"][l],
                                          zeros), torch.float32)
        assert torch.equal(mine, port)
        assert (mine - w[l]).abs().max() < raw["scales"][l].max()


def test_int4_codes_dequantize_as_the_program_reads_them():
    big = weights.big_trunk(tinybench.CONFIG, 3, "cpu")
    w = big["layers"]["wqkv"]
    mine = ref.dequant({k: (v[1] if torch.is_tensor(v) else v)
                        for k, v in w.items()})
    port = dequantize(QuantizedLinear(w["codes"][1], w["scales"][1], None),
                      torch.float32)
    assert torch.equal(mine, port)


def test_reference_verifier_matches_the_programs():
    g = torch.Generator().manual_seed(9)
    gamma, V = 6, 50
    agree = 0
    for trial in range(200):
        sharp = 1.0 + 3.0 * (trial % 4)
        p = torch.softmax(torch.randn((gamma + 1, V), generator=g) * sharp,
                          -1)
        q = torch.softmax(torch.log(p[:gamma]) + torch.randn(
            (gamma, V), generator=g) * 0.5, -1)
        draft = torch.multinomial(q, 1, generator=g)[:, 0]
        noise = {"u": torch.rand((1, gamma), generator=g),
                 "u2": torch.rand((1,), generator=g),
                 "gumbel": -torch.log(-torch.log(
                     torch.rand((V,), generator=g).clamp(min=1e-30)))}
        res = verify("hsd", draft[None], q[None], p[None], noise=noise,
                     num_drafts=1)
        n = int(res.n_matches)
        d = rverify.hsd(draft, q, p, noise["u"][0], noise["u2"][0],
                        noise["gumbel"])
        assert d.n == n and d.tokens == res.tokens[:n + 1].tolist()
        agree += 0 < n < gamma
    assert agree > 20          # partial acceptances are exercised
