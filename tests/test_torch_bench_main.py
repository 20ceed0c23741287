"""The arithmetic of the port's main-path benchmark (hsd_tpu_torch/tools/
bench_main.py) on the CPU: its statistics against bench.run's formula and
its calibration search against bench.calibrate_scale's, both written out
here (importing bench.py would configure JAX at import), and one row end
to end on a 2-layer coupled pair with device="cpu".
"""
import numpy as np
import pytest
import torch

from hsd_tpu_torch.config import ModelConfig
from hsd_tpu_torch.tools import bench_main as B

torch.set_num_threads(2)


def bench_run_stats(accepts, toks, secs):
    """bench.run (bench.py:70-93): per-prompt BE over the executed blocks,
    its mean, and 1.96 * std(ddof=1) / sqrt(n)."""
    per_prompt = [float(np.mean(np.asarray(a) + 1)) for a in accepts
                  if len(a)]
    be = float(np.mean(per_prompt))
    ci = (1.96 * float(np.std(per_prompt, ddof=1)) / len(per_prompt) ** 0.5
          if len(per_prompt) > 1 else 0.0)
    return be, toks / secs, ci


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_stats_match_bench_run(seed):
    rng = np.random.default_rng(seed)
    accepts = [rng.integers(0, 11, size=rng.integers(20, 50)).tolist()
               for _ in range(10)]
    toks, secs = int(rng.integers(2000, 2600)), float(rng.uniform(50, 150))
    got = B.row_stats(accepts, toks, secs)
    be, tok_s, ci = bench_run_stats(accepts, toks, secs)
    assert got["be"] == pytest.approx(be, rel=1e-12)
    assert got["ci95"] == pytest.approx(ci, rel=1e-12)
    assert got["tok_s"] == pytest.approx(tok_s, rel=1e-12)
    assert got["tokens"] == toks and got["seconds"] == secs
    np.testing.assert_allclose(got["per_run"],
                               [np.mean(np.asarray(a) + 1) for a in accepts],
                               rtol=1e-12)


def test_row_stats_single_run_has_no_ci():
    got = B.row_stats([[3, 4, 10]], 20, 2.0)
    assert got["be"] == pytest.approx(6.666666666666667)
    assert got["ci95"] == 0.0
    assert got["tok_s"] == 10.0


def bench_calibrate(be_at, target_be=5.99, probes=4, hi0=1.65):
    """bench.calibrate_scale's search (bench.py:96-138) without the
    rounding of its log."""
    log = []

    def probe(s):
        be = be_at(s)
        log.append((s, be))
        return be

    lo, hi = 1.0, hi0
    be_hi = probe(hi)
    if abs(be_hi - target_be) < 0.15:
        return hi, log
    while be_hi > target_be and hi < 4.0:
        lo, hi = hi, hi * 1.4
        be_hi = probe(hi)
    for _ in range(probes):
        mid = 0.5 * (lo + hi)
        if probe(mid) < target_be:
            hi = mid
        else:
            lo = mid
        if abs(log[-1][1] - target_be) < 0.1:
            return log[-1][0], log
    return 0.5 * (lo + hi), log


@pytest.mark.parametrize("be_at", [
    lambda s: 7.2 - 0.8 * s,             # the first probe lands (5.88)
    lambda s: 9.0 - 2.0 * s,             # bisection below 1.65
    lambda s: 12.0 - 2.0 * s,            # the upper end rises first
    lambda s: 8.0 if s < 1.5 else 4.0,   # bisection runs out of probes
    lambda s: 9.0 - 0.5 * s,             # raised past 4.0, still above
], ids=["first", "bisect", "raise", "exhaust", "cap"])
def test_calibration_path_matches_bench(be_at):
    scale, log = B.calibrate_scale(be_at)
    want_scale, want_log = bench_calibrate(be_at)
    assert log == want_log
    assert scale == want_scale


def test_against_band():
    inside = B.against_band("hsd_k1", {"be": 7.6})
    assert inside["inside"] and inside["outside_by"] == 0.0
    below = B.against_band("tokenwise_k1", {"be": 5.5})
    assert not below["inside"]
    assert below["outside_by"] == pytest.approx(6.149 - 0.405 - 5.5)
    assert B.against_band("ar", {"be": 1.0}) is None


def test_seed_mapping():
    assert B.seed_of(B.FOLD["hsd"], B.RUN0 + 3) == 1103
    assert B.seed_of(B.FOLD["k11"], B.WARM) == 3999
    seeds = {B.seed_of(f, o) for f in B.FOLD.values()
             for o in [B.WARM] + [B.RUN0 + i for i in range(B.N_RUNS)]}
    assert len(seeds) == len(B.FOLD) * (B.N_RUNS + 1)


CFG_S = ModelConfig.tiny(vocab_size=128, hidden_size=128,
                         intermediate_size=256)
CFG_B = ModelConfig.tiny(vocab_size=128, hidden_size=256,
                         intermediate_size=512, tie_word_embeddings=False)


def test_rows_end_to_end_on_cpu():
    """The k1, k11 and ar rows through bench_main on a 2-layer coupled
    pair: statistics in range, the calibrated tokenwise row repeatable,
    the K = 11 prefills' rows counted and no kernel launched on the CPU."""
    out = B.measure(["k1", "k11", "ar"], 1.5, CFG_S, CFG_B, "cpu",
                    n_runs=2, ar_new=8)
    rows = out["rows"]
    assert set(rows) == {"hsd_k1", "tokenwise_k1", "hsd_k11",
                         "tokenwise_k11", "ar"}
    for name in ("hsd_k1", "tokenwise_k1", "hsd_k11", "tokenwise_k11"):
        r = rows[name]
        assert len(r["per_run"]) == 2
        assert 1.0 <= r["be"] <= B.GAMMA + 1
        assert r["tokens"] >= 2 and r["seconds"] > 0
        assert not any(r["launches"].values())
    pre = out["prefill_k11"]
    assert pre["target"]["rows"] == 11 * 63
    assert pre["draft"]["rows"] == 11 * 62
    assert pre["target"]["launches"] == {} and pre["target"]["peak_gib"] is None
    assert 1 <= rows["ar"]["tokens"] <= 8

    # a seeded row repeats exactly
    fwd, ops = B.make_coupled_target(CFG_S, CFG_B)
    draft, target, _ = B.build_pair(CFG_S, CFG_B, 1.5, "cpu")
    gen = B.spec_gen(CFG_S, CFG_B, "tokenwise", 1, fwd, ops)
    a = B.run_row(gen, draft, target, B.FOLD["tokenwise"], 2, "cpu",
                  CFG_B.vocab_size, warm=False)
    assert a["per_run"] == rows["tokenwise_k1"]["per_run"]


def bench_serving_requests(vocab, reqs, max_new):
    """bench.py's draw (:162-166), written out: a prompt length in [32,
    64), that many ids in [1, vocab - 2), then a budget in [max_new // 4,
    max_new]."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(reqs):
        n = int(rng.integers(32, 64))
        ids = rng.integers(1, vocab - 2, (n,)).tolist()
        out.append((ids, int(rng.integers(max_new // 4, max_new + 1))))
    return out


def test_serving_requests_are_the_references():
    got = B.serving_requests(151936)
    assert got == bench_serving_requests(151936, 32, 48)
    assert all(32 <= len(p) < 64 and 12 <= mn <= 48 for p, mn in got)
    assert all(1 <= t < 151936 - 2 for p, _ in got for t in p)


def test_serving_row_on_cpu(monkeypatch):
    """The serving row through bench_main at a tiny size (4 slots, 8
    requests, 12 new tokens, 2 reps) on the 2-layer pair's draft and small
    trunk: both schedules serve every request with the same streams (one
    generator a request id), so BE and the committed tokens repeat over
    reps; the warm engine is outside the clock and the counters; measure's
    `serving` row wires it after freeing the big trunk."""
    draft, target, _ = B.build_pair(CFG_S, CFG_B, 1.5, "cpu")
    row = B.serving_row(draft, target.small, CFG_S, "cpu", n_slots=4,
                        reqs=8, max_new=12, reps=2)
    assert len(row["ratios"]) == 2 and row["ratio"] in row["ratios"]
    assert row["reference"] == {"ratio": 1.256,
                                "ratios": [1.245, 1.256, 1.261], "be": 4.66}
    for rep in row["reps"]:
        assert rep["same_streams"]
        assert rep["cont_tokens"] == rep["lock_tokens"] == row["cont_tokens"]
        assert rep["be"] == row["be"] and 1.0 <= rep["be"] <= B.SRV_GAMMA + 1
        assert rep["cont_tok_s"] > 0 and rep["lock_tok_s"] > 0
        assert 0 < rep["pool_blocks_cont"] <= rep["pool_blocks_lock"]
        assert not any(rep["launches_cont"].values())
    calls = []
    monkeypatch.setattr(B, "serving_row",
                        lambda d, s, cfg, dev: calls.append(
                            (cfg, dev)) or {"be": 2.0, "cont_tok_s": 1.0,
                                            "lock_tok_s": 1.0, "ratio": 1.0,
                                            "ratios": [1.0]})
    out = B.measure(["serving"], 1.5, CFG_S, CFG_B, "cpu")
    assert calls == [(CFG_S, "cpu")] and out["rows"]["serving"]["be"] == 2.0
