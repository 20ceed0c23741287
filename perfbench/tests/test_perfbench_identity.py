"""What a configuration that states no `head_dim`, no untied draft head,
no reference and no work of its own reads: exactly what the harness read
before those could be stated. Frozen from that harness: the work `costs`
counts at the cell's shapes, and the bits of the default reference's
logits on the tiny pairs (CPU, float32, one thread; compared only on the
torch build and instruction set they were taken on, `FROZEN_ON`)."""
import hashlib
import json
import platform

import pytest
import torch

from perfbench.harness import cell, costs, coupled
from perfbench.reference import model as ref

import tinybench

SPEC = json.loads((tinybench.PKG / "configs" / "qwen2.5-14b-int4.json")
                  .read_text())
VERIFY = [(11, 760 + 3 * i) for i in range(96)]      # 1056 rows
STEP = [(1, 790 + 3 * i) for i in range(96)]         # 96 rows
QUANT = {"draft": "int8sym", "small": "bf16", "big": "int4"}
# (trunk, seqs, head): (ops, bytes)
COSTS = {
    "verify_big": ("big", VERIFY, True, (30491305574400.0, 24461058048.0)),
    "verify_small": ("small", VERIFY, True,
                     (1125767774208.0, 2067423232.0)),
    "draft_step": ("draft", STEP, True, (102548963328.0, 1742651392.0)),
    "prefill_big": ("big", [(1023, 0)], False,
                    (27546762608640.0, 7018834944.0)),
    "prefill_small": ("small", [(1023, 0)], False,
                      (777166258176.0, 730056960.0)),
    "prefill_draft": ("draft", [(1022, 0)], False,
                      (776362610688.0, 383398400.0)),
}
# the bits of a float32 CPU product follow the torch build and the
# instruction set: LOGITS was taken on this (torch, machine, capability)
FROZEN_ON = ("2.13.0+cpu", "x86_64", "AVX512")
# sha256 (first 32 hex digits) of the logits, per pair, trunk, precision
LOGITS = {
    ("tiny-pair", "draft", "f32"): "4336b09bf3417610a0580dc89342ac39",
    ("tiny-pair", "draft", "fp8"): "95c730e5ac4f1fee2137b3e4e4ef95c6",
    ("tiny-pair", "small", "f32"): "c0ecb799f8cada48ec6ddee36450175a",
    ("tiny-pair", "small", "fp8"): "32836df9f2bfa5b5041e02c5ede3505b",
    ("tiny-pair", "big", "f32"): "554e6dffe37eb1b23d962e94fdd9a932",
    ("tiny-pair", "big", "fp8"): "5c774a114336ca51580bc2ea4f068dc9",
    ("tiny-moe", "draft", "f32"): "3f69cf8e8f2c1010f81cf22d8d6b8cec",
    ("tiny-moe", "draft", "fp8"): "293f50e4155cdab4df51563f25abdca6",
    ("tiny-moe", "big", "f32"): "ff3f4a9ca848e3415db0db89cf0dbc65",
    ("tiny-moe", "big", "fp8"): "514e0190f69e4df4cddd9a2b10810eed",
}


def shape(trunk):
    return SPEC if trunk == "big" else SPEC["draft"]


@pytest.mark.parametrize("name", sorted(COSTS))
def test_costs_at_the_cells_shapes_are_the_frozen_counts(name):
    m, seqs, head, want = COSTS[name]
    assert costs.forward(costs.trunk(shape(m), QUANT[m]), seqs,
                         head=head) == want


def test_default_work_is_the_frozen_counts():
    served = coupled.Served(*([None] * 6), raw=None,
                            shapes={m: shape(m) for m in QUANT}, quant=QUANT,
                            lam=0.0, target=None)
    fwd = cell.work_of(served)
    for m, seqs, head, want in COSTS.values():
        assert fwd[m](seqs, head) == want


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("pair,trunk,precision", sorted(LOGITS))
def test_default_reference_logits_are_the_frozen_bits(one_thread, pair, trunk,
                                                      precision):
    here = (torch.__version__, platform.machine(),
            torch.backends.cpu.get_cpu_capability())
    if here != FROZEN_ON:
        pytest.skip(f"logits frozen on {FROZEN_ON}, not {here}")
    cfg = tinybench.CONFIG if pair == "tiny-pair" else tinybench.MOE
    served = coupled.build(cfg, 2 ** 31 + 5, "cpu", 1)
    g = torch.Generator().manual_seed(17)
    seqs = [torch.randint(2, 1000, (n,), generator=g).tolist()
            for n in (24, 17)]
    wanted = [list(range(20, 24)), list(range(0, 17, 4))]
    out = ref.logits(served.shapes[trunk], served.raw[trunk], seqs, wanted,
                     precision=precision, device="cpu")
    got = hashlib.sha256(torch.cat(out).numpy().tobytes()).hexdigest()
    assert got[:32] == LOGITS[(pair, trunk, precision)]
