"""A configuration that brings its own trunk, on the CPU at a tiny size,
from new files only (`tinybench.make_root`; no file of the harness is
edited): its own plain reference (`reference/<name>.py`, named by its
`.py`), which the check and the float8 control call; its own work count,
which the rooflines and MFU read; a published `head_dim` other than
hidden_size over the heads, dense and MoE; a draft with a head of its
own."""
import time

import pytest
import torch

from perfbench.harness import cell, check, discover

import tinybench

SEED = 2 ** 31 + 23
PEAKS = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}

SHIFT = '''"""The default reference, 1.0 added to logit column 7 of each row;
the precision of every call kept in CALLS."""
from perfbench.reference import model

CALLS = []


def logits(shape, raw, seqs, wanted, precision="f32", device=None):
    CALLS.append(precision)
    out = model.logits(shape, raw, seqs, wanted, precision=precision,
                       device=device)
    for rows in out:
        rows[:, 7] += 1.0
    return out
'''
SHIFTED_PY = '''"""The tiny pair, its big trunk judged by tiny_shift."""
from perfbench.harness import coupled, discover

SHIFT = discover.reference(__file__, "tiny_shift")


def build(spec, seed, device, rows_per_slot):
    served = coupled.build(spec, seed, device, rows_per_slot)
    return served._replace(reference={"big": SHIFT.logits})
'''
DOUBLED_PY = '''"""The tiny pair, its work counted at twice the ops."""
from perfbench.harness import cell, coupled


def doubled(work):
    def twice(seqs, head):
        ops, byts = work(seqs, head)
        return 2 * ops, byts
    return twice


def build(spec, seed, device, rows_per_slot):
    served = coupled.build(spec, seed, device, rows_per_slot)
    return served._replace(work={m: doubled(w) for m, w in
                                 cell.work_of(served).items()})
'''


def wide(cfg, name):
    """cfg with 4 heads (2 kv heads) of 64 at hidden_size 128, both
    trunks."""
    heads = {"num_attention_heads": 4, "num_key_value_heads": 2,
             "head_dim": 64}
    return dict(cfg, name=name, **heads, draft=dict(cfg["draft"], **heads))


HD = wide(tinybench.CONFIG, "tiny-hd")
MOE_HD = wide(tinybench.MOE, "tiny-moe-hd")
UNTIED = dict(tinybench.CONFIG, name="tiny-untied",
              draft=dict(tinybench.CONFIG["draft"],
                         tie_word_embeddings=False))
SHIFTED = dict(tinybench.CONFIG, name="tiny-shifted")
DOUBLED = dict(tinybench.CONFIG, name="tiny-doubled")


@pytest.fixture(autouse=True)
def short_warmup(monkeypatch):
    monkeypatch.setattr(cell, "WARMUP_TIMEOUT_S", 5.0)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tinybench.make_root(
        tmp_path_factory.mktemp("bench"),
        extra=[(HD, None), (MOE_HD, None), (UNTIED, None),
               (SHIFTED, SHIFTED_PY), (DOUBLED, DOUBLED_PY)],
        files={"reference/tiny_shift.py": SHIFT})
    return discover.Bench(root, root / "perfbench")


def run(bench, name, traced=False):
    return cell.run_cell(bench, f"{name}.mini", SEED, 1.5, traced, "cpu",
                         time.perf_counter())


@pytest.mark.parametrize("name", ["tiny-hd", "tiny-moe-hd", "tiny-untied"])
def test_published_widths_run_correct(bench, name):
    out = run(bench, name)
    assert out["result"]["correct"], out["lines"]
    assert out["numbers"]["records"] >= 2
    served = out["served"]
    if name == "tiny-untied":
        head = served.raw["small"]["lm_head"]
        assert head.shape == (128, 1024) and head.dtype == torch.bfloat16
        assert served.raw["draft"]["lm_head"] is head
        assert served.params_draft.lm_head is head
        # the head carries logit_scale, the embedding is as drawn
        assert served.raw["small"]["embed"].float().std() < 0.025
        assert head.float().std() > 0.025
    else:
        for cfg in (served.cfg_target, served.cfg_draft):
            assert cfg.head_dim_ == 64 != cfg.hidden_size // cfg.num_heads
        wqkv = served.raw["big"]["layers"]["wqkv"]["codes"]
        assert wqkv.shape[-1] == (4 + 2 * 2) * 64
        assert served.raw["small"]["layers"]["wo"].shape[-2:] == (256, 128)


def test_supplied_reference_decides_correct(bench):
    shifted = run(bench, "tiny-shifted")
    plain = run(bench, "tiny-pair")          # the same sizes and seed
    assert plain["result"]["correct"], plain["lines"]
    assert shifted["result"]["correct"] is False
    bad = [k for k, _, _, ok in shifted["lines"] if not ok]
    assert "big_logit_err" in bad
    assert shifted["numbers"]["big_logit_err"] > 1.0 > \
        plain["numbers"]["big_logit_err"]
    # only the big trunk's reference was given: the draft's law, the
    # verifier's decisions and the harvest are judged as before
    assert set(bad) <= {"big_logit_err", "target_tv"}
    calls = shifted["served"].reference["big"].__globals__["CALLS"]
    assert calls == ["f32"]
    check.control(shifted["served"], shifted["temperature"],
                  shifted["records"], shifted["refl"], "cpu")
    assert calls == ["f32", "fp8"]


def test_supplied_work_moves_mfu(bench, monkeypatch):
    seen = []
    context = cell.context

    def keep(*a):
        seen.append(a)
        return context(*a)
    monkeypatch.setattr(cell, "peaks_of", lambda kind: PEAKS)
    monkeypatch.setattr(cell, "context", keep)
    out = run(bench, "tiny-doubled", traced=True)
    assert out["result"]["correct"], out["lines"]
    mfu = bench.metric("model.mfu").read
    served, *rest = seen[0]
    own = mfu(context(served, *rest))
    default = mfu(context(served._replace(work=None), *rest))
    assert out["result"]["metrics"]["model.mfu"]["value"] == own
    assert own == 2 * default > 0
