"""The harness end to end on the CPU at a tiny size: a configuration, mix,
cell and per-layer metric found by name in a temporary directory; a sound
run is correct; the timed path broken underneath makes it incorrect; the
float8 control fails a limit; a dense and an MoE target alike."""
import time

import pytest
import torch

from perfbench.harness import cell, check, discover, faults
from perfbench.harness.instrument import SPANS

import tinybench

SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def short_warmup(monkeypatch):
    # a run whose pool makes no progress gives up its warm-up in seconds
    monkeypatch.setattr(cell, "WARMUP_TIMEOUT_S", 5.0)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tinybench.make_root(tmp_path_factory.mktemp("bench"))
    return discover.Bench(root, root / "perfbench")


def run(bench, name="tiny-pair.mini", traced=False, fault=None, seed=SEED,
        post_faults=None):
    return cell.run_cell(bench, name, seed, 1.5, traced, "cpu",
                         time.perf_counter(), fault=fault,
                         post_faults=post_faults)


@pytest.mark.parametrize("name", ["tiny-pair.mini", "tiny-moe.mini"])
def test_sound_run_is_correct(bench, name):
    out = run(bench, name)
    res = out["result"]
    assert res["correct"], out["lines"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"serve_tok_s", "tpot_p90_ms",
                                   "block_efficiency", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert 1.0 <= res["metrics"]["block_efficiency"]["value"] <= 4.0
    assert list(res)[-1] == "check"
    assert out["numbers"]["records"] >= 2
    assert out["numbers"]["harvest_checked"] == res["attempted"]


def test_traced_run_reads_per_layer_metrics(bench):
    res = run(bench, traced=True)["result"]
    assert res["correct"]
    m = res["metrics"]
    # the new metric file is found by name; no device trace on the CPU,
    # so the device readers report nothing rather than a zero
    assert m["blocks.count"]["value"] > 0
    assert 0 < m["server.prefill_share"]["value"] < 100
    assert m["pool.block_ms"]["value"] > 0
    for name in ("linear.route_a_share", "kernels.verify_roofline",
                 "kernels.draft_roofline", "device.idle_share"):
        assert name not in m


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_makes_the_run_incorrect(bench, fault):
    out = run(bench, fault=faults.FAULTS[fault])
    assert out["result"]["correct"] is False, out["numbers"]


def test_faults_planted_after_the_window_fail_a_limit(bench):
    post = {k: v for k, v in faults.FAULTS.items() if k != "harvest_altered"}
    out = run(bench, post_faults=post)
    assert out["result"]["correct"], out["lines"]
    for name, numbers in out["faults"].items():
        assert not check.verdict(dict(numbers, harvest_off=0),
                                 tinybench.LIMITS)[0], (name, numbers)


def test_control_fails_a_limit(bench):
    out = run(bench)
    ctrl = check.control(out["served"], out["temperature"], out["records"],
                         out["refl"], "cpu")
    limits = tinybench.LIMITS
    assert any(ctrl[k] > limits[k] for k in ("draft_tv", "target_tv",
                                             "big_logit_err"))
    assert out["result"]["correct"]


def test_spans_are_the_instrumented_layers():
    assert set(SPANS) >= {"server.admit", "pool.block", "linear.route_a",
                          "model.target_verify", "model.draft"}
