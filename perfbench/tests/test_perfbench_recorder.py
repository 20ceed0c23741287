"""The per-layer readers of the program's own recorder (`harness/
recorder.py` over `hsd_tpu_torch.utils.profiling.snapshot()`): each on a
hand-built snapshot, None on an empty one and where the program has no
recorder, and the counter readers in a traced run of the tiny cell."""
import importlib.util
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench.harness import cell, discover
from hsd_tpu_torch.utils import profiling

import tinybench

PKG = Path(__file__).resolve().parents[1]
SNAP = {
    "spans": {"pool.verify": {"calls": 4, "host_s": 0.2, "self_s": 0.2,
                              "device_s": 0.18},
              "linear.dequant": {"calls": 900, "host_s": 1.0, "self_s": 1.0,
                                 "device_s": 9.0},
              "pool.block": {"calls": 4, "host_s": 5.0, "self_s": 1.0}},
    "counters": {"server.admissions": 2, "server.prefill_rows": 2046,
                 "server.prefill_pad_rows": 440, "server.prompt_tokens": 1600,
                 "server.prefix_tokens": 750},
    "requests": {7: {"submitted": 10.0, "prefill": 16.0, "harvest": 30.0},
                 8: {"submitted": 11.0, "prefill": 20.0},
                 3: {"submitted": 1.0, "harvest": 12.0}}}
WANT = {"server.queue_wait_ms": (6.0 + 9.0) / 2 * 1e3,
        "server.prefill_pad_share": 100.0 * 440 / 2046,
        "server.prefix_recompute_share": 100.0 * 750 / 1600,
        "pool.verify_ms": 180.0 / 4,
        "linear.dequant_share": 100.0 * 9.0 / 30.0}
CTX = SimpleNamespace(slice_s=30.0)


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m", PKG / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_snapshot(name, monkeypatch):
    monkeypatch.setattr(profiling, "snapshot", lambda: SNAP)
    assert reader(name)(CTX) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_an_empty_snapshot(name, monkeypatch):
    monkeypatch.setattr(profiling, "snapshot", lambda: {
        "spans": {}, "counters": {}, "requests": {}})
    assert reader(name)(CTX) is None
    # a program whose profiling module keeps no recorder
    monkeypatch.delattr(profiling, "snapshot")
    assert reader(name)(CTX) is None


def test_device_readers_need_events(monkeypatch):
    """On the CPU a device span has no CUDA events: nothing to read."""
    snap = {"spans": {k: {x: y for x, y in v.items() if x != "device_s"}
                      for k, v in SNAP["spans"].items()},
            "counters": {}, "requests": {}}
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    assert reader("pool.verify_ms")(CTX) is None
    assert reader("linear.dequant_share")(CTX) is None


def test_traced_tiny_run_reads_the_counters(tmp_path):
    root = tinybench.make_root(tmp_path)
    bench = discover.Bench(root, root / "perfbench")
    profiling.reset()
    try:
        out = cell.run_cell(bench, "tiny-pair.mini", 2 ** 31 + 5, 1.5, True,
                            "cpu", time.perf_counter())
    finally:
        snap = profiling.snapshot()
        profiling.reset()
    res, info = out["result"], out["info"]
    assert res["correct"]
    m = res["metrics"]
    assert m["server.queue_wait_ms"]["value"] >= 0
    assert 0 < m["server.prefill_pad_share"]["value"] < 100
    # the mix's 8-token shared prefix repeats in every admission after the
    # slice's first
    assert 0 < m["server.prefix_recompute_share"]["value"] < 100
    for name in ("pool.verify_ms", "linear.dequant_share"):
        assert name not in m             # no CUDA events on the CPU
    # the program's spans count what the harness's spans of the same names
    # count
    assert snap["spans"]["pool.block"]["calls"] == info["blocks"] > 0
    assert snap["spans"]["server.admit"]["calls"] == info["admissions"] > 0
