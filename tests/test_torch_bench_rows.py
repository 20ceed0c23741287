"""The rows of `hsd_tpu_torch/tools/bench_main.py` that build no 14B pair
(gsm8k_parity, eagle_serving, realistic, realistic_eagle) on the CPU: their
arithmetic against bench.py's (`:206-475`, written out here: importing bench.py
would configure JAX at import) and each row end to end at a tiny size
with device="cpu"."""
import collections

import numpy as np
import pytest
import torch

from hsd_tpu_torch.config import ModelConfig
from hsd_tpu_torch.models.eagle import EagleConfig
from hsd_tpu_torch.tools import bench_main as B

torch.set_num_threads(2)


def bench_floor(cats_a, cats_b, perms):
    """bench.py's permutation floor (:455-468), written out."""
    def tv(da, db):
        ks = set(da) | set(db)
        return 0.5 * sum(abs(da.get(k, 0) - db.get(k, 0)) for k in ks)
    pool = cats_a + cats_b
    n_half = len(cats_a)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(perms):
        perm = rng.permutation(len(pool))
        a = collections.Counter(pool[i] for i in perm[:n_half])
        b = collections.Counter(pool[i] for i in perm[n_half:])
        out.append(tv({k: v / n_half for k, v in a.items()},
                      {k: v / (len(pool) - n_half) for k, v in b.items()}))
    return out


def test_permutation_floor_is_the_references():
    rng = np.random.default_rng(3)
    a = [str(d) for d in rng.integers(0, 4, 60)]
    b = [str(d) for d in rng.integers(0, 5, 60)]
    assert B.permutation_floor(a, b, 50) == pytest.approx(
        bench_floor(a, b, 50), abs=1e-12)
    assert B.first_digit("x 42 y") == "4" and B.first_digit("no") == "none"
    assert B.first_digit(None) == "none"


def test_gsm8k_parity_row_on_cpu():
    row = B.gsm8k_parity_row("cpu", questions=4, reps=3, max_new=12,
                             perms=40)
    assert row["n_outputs"] == 12
    for m in ("tokenwise", "hsd"):
        assert abs(sum(row[m]["law"].values()) - 1) < 1e-12
        assert row[m]["be"] >= 1.0 and row[m]["seconds"] > 0
    assert 0 <= row["answer_tv"] <= 1
    assert row["noise_floor_tv50"] <= row["noise_floor_tv95"]
    assert row["at_or_below_tv95"] == (row["answer_tv"]
                                       <= row["noise_floor_tv95"])
    assert row["reference"]["answer_tv"] == 0.048
    # the row's questions are bench.py's
    assert B.parity_questions(2)[1] == {
        "question": "A box holds 4 pears and gains 3 more. How many pears "
                    "are in the box?", "answer": "#### 7"}


def test_eagle_serving_requests_are_the_references():
    """bench.py's draws (:387-394), written out: the warm prompt first,
    then a length in [32, 64) and that many ids in [10, 1000) a request."""
    rng = np.random.default_rng(0)
    warm = rng.integers(10, 1000, (64,)).tolist()
    want = []
    for _ in range(24):
        n = int(rng.integers(32, 64))
        want.append(rng.integers(10, 1000, (n,)).tolist())
    assert B.eagle_serving_requests() == (warm, want)
    cfg, ecfg = B.eagle_configs()
    assert cfg.gptq_mxu_bf16 and cfg.eos_token_id == cfg.vocab_size
    assert (ecfg.version, ecfg.top_k, ecfg.depth, ecfg.total_tokens,
            ecfg.draft_vocab_size) == (1, 10, 6, 59, 32000)


def test_eagle_serving_row_on_cpu():
    # the requests' ids are bench.py's, in [10, 1000)
    cfg = ModelConfig.tiny(vocab_size=1024, hidden_size=128,
                           intermediate_size=256, eos_token_id=1024)
    ecfg = EagleConfig(hidden_size=128, target_hidden_size=128, num_heads=4,
                       num_kv_heads=2, vocab_size=1024, draft_vocab_size=1024,
                       intermediate_size=256, top_k=3, depth=3,
                       total_tokens=9, rope_theta=cfg.rope_theta,
                       dtype=torch.float32, version=1)
    row = B.eagle_serving_row("cpu", cfg, ecfg, n_slots=2, reqs=3,
                              max_new=8, bucket=64)
    assert row["reqs"] == 3 and 3 <= row["tokens"] <= 24
    assert 1.0 <= row["be_requests"] <= ecfg.depth + 2
    assert 1.0 <= row["be"] <= ecfg.depth + 2
    assert row["tok_s"] > 0 and row["reference_be"] == 3.978
    assert not any(row["launches"].values())


def bench_tau_search(be_at):
    """bench.py's tau search (:277-296), written out."""
    cal = []

    def probe(t):
        b = be_at(t)
        cal.append((round(t, 3), round(b, 3)))
        return b

    lo_t, hi_t = 1.0, 2.0
    be = probe(1.0)
    if be > 5.99:
        while be > 5.99 and hi_t < 6.0:
            be = probe(hi_t)
            if be > 5.99:
                lo_t, hi_t = hi_t, hi_t * 1.4
        for _ in range(7):
            if abs(be - 5.99) < 0.1:
                break
            tau = 0.5 * (lo_t + hi_t)
            be = probe(tau)
            if be > 5.99:
                lo_t = tau
            else:
                hi_t = tau
    return min(cal, key=lambda tb: abs(tb[1] - 5.99))[0], cal


@pytest.mark.parametrize("curve", [
    lambda t: 11.0 - 3.5 * t,            # crosses inside [1, 2]
    lambda t: 9.0 / t ** 0.4,            # needs the 1.4x widening
    lambda t: 5.0 + 0.0 * t,             # below the target at tau 1
    lambda t: 8.517 - 6.1 * (t - 1.0) ** 0.9,   # the reference's probes' shape
])
def test_tau_search_is_the_references(curve):
    tau, cal = B.calibrate_tau(curve)
    want_tau, want_cal = bench_tau_search(curve)
    assert [t for t, _ in cal] == pytest.approx([t for t, _ in want_cal],
                                                abs=5e-4)
    assert tau == pytest.approx(want_tau, abs=5e-4)


def test_uplift_is_the_references():
    rows = {"tokenwise": {"be": 6.315, "ci95": 0.161},
            "hsd": {"be": 6.581, "ci95": 0.152},
            "blockwise": {"be": 6.465, "ci95": 0.154}}
    r, ci = B.uplift(rows, "hsd")
    assert round(r, 4) == 1.0421 and round(ci, 4) == 0.0359
    r, ci = B.uplift(rows, "blockwise")
    assert round(r, 4) == 1.0238 and round(ci, 4) == 0.0357


def test_realistic_row_on_cpu():
    """The row end to end at a tiny size (vocab 64, a 1-layer target and
    draft, 20 training steps, 2-run probes, 3 final runs a method)."""
    configs = B.realistic_configs(V=64, target_hidden=32, target_layers=1,
                                  draft_hidden=16, draft_layers=1)
    row = B.realistic_row("cpu", steps=20, n_final=3, probe_runs=2,
                          max_new=16, configs=configs,
                          lang_kw=dict(n_words=30), batch=8, seq=24)
    assert set(row["rows"]) == {"tokenwise", "blockwise", "hsd"}
    for r in row["rows"].values():
        assert 1.0 <= r["be"] <= B.GAMMA + 1 and r["tokens"] >= 3
    assert row["target_ce"] < row["target_ce0"]
    assert row["distill_ce"] < row["distill_ce0"]
    assert row["tau"] in [t for t, _ in row["cal"]]
    for m in ("hsd", "blockwise"):
        r, ci = B.uplift(row["rows"], m)
        assert row[f"uplift_{m}"] == r and row[f"uplift_{m}_ci95"] == ci
        assert isinstance(row[f"uplift_{m}_inside_band"], bool)
    assert 0 < row["alpha"] <= 1


def test_main_rejects_bad_rows(capsys):
    with pytest.raises(SystemExit):
        B.main(["--rows", "nope"])
    with pytest.raises(SystemExit):
        B.main(["--rows", "k1,gsm8k_parity"])       # k1 needs --scale
    assert "need --scale" in capsys.readouterr().err


def test_realistic_eagle_row_on_cpu():
    """The EAGLE row end to end at a tiny size (vocab 64, a 2-layer 32-wide
    target trained 20 steps, the head 12 steps, 16 tokens a run): every
    mode's BE in [1, depth + 1], a histogram over depth + 1 accept counts,
    the head's loss lower after its steps."""
    configs = B.realistic_configs(V=64, target_hidden=32, target_layers=2,
                                  draft_hidden=16, draft_layers=1)
    row = B.realistic_eagle_row("cpu", steps=20, head_steps=12, max_new=16,
                                configs=configs, lang_kw=dict(n_words=30),
                                batch=4, seq=24, head_inter=64)
    assert set(row["modes"]) == set(B.EAGLE_MODES)
    for r in row["modes"].values():
        assert 1.0 <= r["be"] <= 7.0 and r["tokens"] >= 8
        assert len(r["accept_hist"]) >= 7
        assert abs(sum(r["accept_hist"]) - 1.0) < 1e-9
    assert row["uplift_hsd_vs_typical"] == (row["modes"]["hsd"]["be"]
                                            / row["modes"]["typical"]["be"])
    assert row["head_metrics"][-1]["loss"] < row["head_metrics"][0]["loss"]
    assert row["target_ce"] < row["target_ce0"]
