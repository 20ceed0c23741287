"""The port's recorder of spans and counters (`hsd_tpu_torch/utils/
profiling.py`) on the CPU.

* Off (no profiler window open): a SlotEngine run records nothing, and an
  off span reads no clock and opens no record_function range.
* On, inside `profiling.trace(tmp)` (a tiny pair with a packed-int4
  target, a bucket past the 64 rows above which a quantized product
  dequantizes, M = 3 with the on-device refill): every span the engines set
  appears; pool.block counts the pool blocks, server.admit the prefills
  plus the stagings; the exported trace.json nests the pool's spans in
  pool.block and linear.dequant in linear.route_a; spans.json is the
  snapshot.
* Counters: the prefill rows and their left-padding rows for known prompt
  lengths, the shared prefix of two prompts, the queue wait under a
  patched clock; the token streams with the recorder on equal those off.
"""
import json
import time

import pytest
import torch

from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine.server import SlotEngine
from hsd_tpu_torch.eval.synthetic import init_quantized_params
from hsd_tpu_torch.models import init_params
from hsd_tpu_torch.utils import profiling

torch.set_num_threads(2)
CFG = ModelConfig.tiny(vocab_size=64)
PD = init_params(CFG, seed=0, device="cpu")
PT = init_params(CFG, seed=1, device="cpu")
PQ = init_quantized_params(CFG, seed=2, bits=4, device="cpu")
SPANS = ("server.step", "server.admit", "model.target_prefill",
         "model.draft_prefill", "pool.cache_put", "server.noise",
         "server.host_read", "server.refill", "server.harvest", "pool.block",
         "model.draft", "model.target_verify", "pool.target_law",
         "pool.verify", "pool.commit", "linear.route_a", "linear.dequant")
EMPTY = {"spans": {}, "counters": {}, "requests": {}}


def _engine(bucket=16, params_t=PT, K=1, n_slots=2, M=3, max_new=6):
    eng = EngineConfig(verifier=VerifierConfig(method="hsd", gamma=3,
                                               num_drafts=K),
                       max_new_tokens=max_new, temperature=1.0)
    return SlotEngine(CFG, CFG, eng, n_slots=n_slots, bucket=bucket,
                      params_d=PD, params_t=params_t, admit_batch=2,
                      steps_per_dispatch=M, device="cpu")


def _prompts(n=5):
    return [[3 + (7 * i + j) % 50 for j in range(4 + 3 * i)]
            for i in range(n)]


def _serve(engine, prompts):
    for rid, p in enumerate(prompts):
        engine.submit(rid, p, max_new=3 + rid % 4)
    return {r.rid: r.out_tokens for r in engine.run_all()}


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One run under trace(): (snapshot, the trace's user annotations, pool
    blocks run, prefills and stagings made, spans.json)."""
    tmp = tmp_path_factory.mktemp("trace")
    se = _engine(bucket=80, params_t=PQ)
    made = {"prefill": 0, "stage": 0}
    for name in made:
        def counted(*a, _fn=getattr(se.pool, name), _name=name, **kw):
            made[_name] += 1
            return _fn(*a, **kw)
        setattr(se.pool, name, counted)
    blocks0 = se.stats()["pool_blocks"]
    with profiling.trace(str(tmp)):
        _serve(se, _prompts())
    snap = profiling.snapshot()
    events = json.loads((tmp / "trace.json").read_text())["traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("ph") == "X"]
    saved = json.loads((tmp / "spans.json").read_text())
    profiling.reset()
    return snap, ann, se.stats()["pool_blocks"] - blocks0, made, saved


def test_off_records_nothing():
    _serve(_engine(), _prompts(3))
    assert profiling.snapshot() == EMPTY


def test_off_span_reads_no_clock(monkeypatch):
    def no(*a, **k):
        raise AssertionError("read while the recorder is off")
    monkeypatch.setattr(time, "perf_counter", no)
    monkeypatch.setattr(torch.profiler, "record_function", no)
    s = profiling.span("pool.block")
    assert s is profiling.span("model.draft", device=True)
    with s:
        with profiling.span("pool.verify", device=True):
            pass
    profiling.count("server.admissions", 3)
    profiling.admitted(0, 1.0, [0, 0, 5, 6], 2)
    profiling.harvested(0, 1.0)
    assert profiling.snapshot() == EMPTY


def test_every_span_appears(traced):
    snap, ann, _, _, saved = traced
    assert set(SPANS) <= set(snap["spans"])
    for name in SPANS:
        s = snap["spans"][name]
        assert s["calls"] >= 1 and 0 <= s["self_s"] <= s["host_s"] + 1e-9
        assert "device_s" not in s      # no CUDA event on the CPU
    assert set(SPANS) <= {e["name"] for e in ann}
    assert saved["spans"] == json.loads(json.dumps(snap["spans"]))
    assert saved["counters"] == snap["counters"]


def test_pool_block_counts_the_pool_blocks(traced):
    snap, _, blocks, _, _ = traced
    assert blocks > 0
    assert snap["spans"]["pool.block"]["calls"] == blocks
    for name in ("model.draft", "model.target_verify", "pool.target_law",
                 "pool.verify", "pool.commit"):
        assert snap["spans"][name]["calls"] == blocks, name
    # the children's time is taken out of the block's self time
    blk = snap["spans"]["pool.block"]
    assert blk["self_s"] < blk["host_s"]


def test_admit_counts_prefills_and_stagings(traced):
    snap, _, _, made, _ = traced
    assert made["prefill"] > 0 and made["stage"] > 0
    n = made["prefill"] + made["stage"]
    assert snap["spans"]["server.admit"]["calls"] == n
    assert snap["counters"]["server.admissions"] == n
    for name in ("model.target_prefill", "model.draft_prefill"):
        assert snap["spans"][name]["calls"] == n
    assert snap["spans"]["pool.cache_put"]["calls"] == 2 * n
    assert len(snap["requests"]) == n == len(_prompts())


def _inside(child, parents):
    a, b = child["ts"], child["ts"] + child["dur"]
    return any(p["tid"] == child["tid"] and p["ts"] <= a + 1e-3
               and b <= p["ts"] + p["dur"] + 1e-3 for p in parents)


@pytest.mark.parametrize("child,parent", [
    ("pool.verify", "pool.block"), ("model.draft", "pool.block"),
    ("pool.commit", "pool.block"), ("linear.dequant", "linear.route_a"),
    ("model.target_prefill", "server.admit"), ("pool.block", "server.step")])
def test_trace_nests_spans(traced, child, parent):
    _, ann, _, _, _ = traced
    parents = [e for e in ann if e["name"] == parent]
    children = [e for e in ann if e["name"] == child]
    assert children and all(_inside(c, parents) for c in children)


@pytest.mark.parametrize("K", [1, 2])
def test_prefill_row_counters(tmp_path, K):
    """Two prompts of 5 and 11 tokens in a 16-token bucket: the target's
    prefill runs 15 positions a row, the draft's 14, K rows each."""
    se = _engine(K=K, M=1)
    with profiling.trace(str(tmp_path)):
        se.submit(0, list(range(3, 8)), max_new=2)
        se.submit(1, list(range(20, 31)), max_new=2)
        se.run_all()
    c = profiling.snapshot()["counters"]
    assert c["server.prefill_rows"] == K * 2 * (15 + 14)
    assert c["server.prefill_pad_rows"] == K * ((11 + 11) + (5 + 5))
    assert c["server.prompt_tokens"] == 16 and c["server.admissions"] == 2


@pytest.mark.parametrize("k", [0, 4, 9])
def test_prefix_tokens_is_the_shared_prefix(tmp_path, k):
    shared = list(range(10, 10 + k))
    se = _engine(M=1)
    with profiling.trace(str(tmp_path)):
        se.submit(0, shared + [40, 41, 42], max_new=2)
        se.submit(1, shared + [50, 51], max_new=2)
        se.run_all()
    c = profiling.snapshot()["counters"]
    assert c["server.prefix_tokens"] == k
    assert c["server.prompt_tokens"] == 2 * k + 5


def test_queue_wait_under_a_patched_clock(tmp_path, monkeypatch):
    now = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    se = _engine()
    for rid, p in enumerate(_prompts(4)):
        se.submit(rid, p, max_new=3)
    now[0] = 102.5
    with profiling.trace(str(tmp_path)):
        se.run_all()
    reqs = profiling.snapshot()["requests"]
    assert sorted(reqs) == [0, 1, 2, 3]
    for r in reqs.values():
        assert r == {"submitted": 100.0, "prefill": 102.5, "harvest": 102.5}


def test_streams_equal_on_and_off(tmp_path):
    off = _serve(_engine(bucket=80, params_t=PQ), _prompts())
    with profiling.trace(str(tmp_path)):
        on = _serve(_engine(bucket=80, params_t=PQ), _prompts())
    assert on == off and len(on) == len(_prompts())
    assert profiling.snapshot()["spans"]["pool.block"]["calls"] > 0


def test_snapshot_resolves_device_pairs(monkeypatch):
    """A device span's event pairs become stream seconds at the snapshot,
    after one synchronize, and their events are kept for reuse."""
    class Event:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, end):
            return end.t - self.t          # ms, as torch.cuda.Event's

    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(1))
    clock = profiling.StageClock()
    clock._pending = [("pool.verify", Event(1.0), Event(4.0)),
                      ("pool.verify", Event(5.0), Event(6.5))]
    clock.spans["pool.verify"] = [2, 0.01, 0.01]
    snap = clock.snapshot()
    assert snap["spans"]["pool.verify"]["device_s"] == pytest.approx(4.5e-3)
    assert syncs == [1] and len(clock._events) == 2
    assert clock.snapshot()["spans"]["pool.verify"]["device_s"] == \
        pytest.approx(4.5e-3) and syncs == [1]
