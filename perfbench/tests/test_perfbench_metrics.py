"""The metric arithmetic against hand-worked numbers: the window's rate
with in-flight tokens, the 90th percentile, block efficiency, the work a
forward needs (dense and MoE at the routed top-2), the rooflines and MFU,
and the device trace's reduction."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from perfbench.harness import cell, costs, stats, trace

PKG = Path(__file__).resolve().parents[1]
PEAKS = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}
SHAPE = {"hidden_size": 256, "intermediate_size": 512, "num_hidden_layers": 2,
         "num_attention_heads": 4, "num_key_value_heads": 2,
         "vocab_size": 1000, "tie_word_embeddings": False}


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m", PKG / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_percentile_interpolates():
    assert stats.percentile(list(range(1, 11)), 90) == pytest.approx(9.1)
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.spread([1, 2, 3, 4, 5, 6, 7, 8]) == pytest.approx(4.5 / 4.5)


def test_counters_count_in_flight_tokens_at_their_budget():
    loop = object.__new__(cell.Loop)
    pool = SimpleNamespace(length=torch.tensor([25, 2, 40]),
                           max_new=torch.tensor([30, 0, 20]),
                           acc_sum=torch.tensor([6, 0, 9]),
                           blk_cnt=torch.tensor([3, 0, 4]))
    loop.engine = SimpleNamespace(n_slots=3, slot_rid=[5, -1, 7], bucket=10,
                                  total_committed=100, pool=pool)
    loop.done = [{"acc": 10, "blk": 5}]
    c = loop.counters()
    # 100 harvested + min(25 - 10, 30) + min(40 - 10, 20); the free slot
    # counts nothing
    assert (c["tokens"], c["acc"], c["blk"]) == (135, 25, 12)


def test_end_to_end_arithmetic():
    c0 = {"tokens": 100, "acc": 10, "blk": 5}
    c1 = {"tokens": 160, "acc": 40, "blk": 15}
    done = [{"t": 3.0, "sub": 1.0, "n": 20}, {"t": 4.0, "sub": 3.5, "n": 10}]
    v = cell.end_to_end(c0, c1, 2.0, done, 7.5)
    assert v["serve_tok_s"] == 30.0
    assert v["block_efficiency"] == (30 + 10) / 10
    # tpots 100 ms and 50 ms: p90 = 50 + 0.9 * 50
    assert v["tpot_p90_ms"] == pytest.approx(95.0)
    assert v["setup_s"] == 7.5


def test_dense_forward_work_by_hand():
    tr = costs.trunk(SHAPE, "int4")
    ops, byts = costs.forward(tr, [(11, 100), (11, 50)], head=True)
    # products: attn 256x512 + 256x256, ffn 256x1024 + 512x256, head
    # 256x1000, 22 tokens, 2 layers
    attn = 2 * 22 * (256 * 512 + 256 * 256) * 2
    ffn = 2 * 22 * (256 * 1024 + 512 * 256) * 2
    head = 2 * 22 * 256 * 1000
    keys = 11 * (100 + 6) + 11 * (50 + 6)          # c + (t + 1) / 2 each
    att = 2 * 2 * 4 * 64 * keys * 2
    assert ops == attn + ffn + head + att
    # int4 at half a byte a weight + a bf16 scale a group of 128 rows
    w_attn = 256 * 512 / 2 + 2 * 512 * 2 + 256 * 256 / 2 + 2 * 256 * 2
    w_ffn = 256 * 1024 / 2 + 2 * 1024 * 2 + 512 * 256 / 2 + 4 * 256 * 2
    w_head = 256 * 1000 / 2 + 2 * 1000 * 2
    kv = (111 + 61) * 2 * 2 * 64 * 2 * 2          # k and v, bf16, 2 layers
    assert byts == (w_attn + w_ffn) * 2 + w_head + 22 * 256 + kv


def test_moe_forward_counts_the_routed_top2():
    shape = dict(SHAPE, num_local_experts=4, num_experts_per_tok=2)
    dense = costs.forward(costs.trunk(SHAPE, "int4"), [(11, 0)], head=False)
    moe = costs.forward(costs.trunk(shape, "int4"), [(11, 0)], head=False)
    ffn = 2 * 11 * (256 * 1024 + 512 * 256) * 2
    router = 2 * 11 * 256 * 4 * 2
    assert moe[0] - dense[0] == ffn + router       # two experts, not four
    w_ffn = 256 * 1024 / 2 + 2 * 1024 * 2 + 512 * 256 / 2 + 4 * 256 * 2
    hit = 4 * (1 - 0.5 ** 11)                      # experts given a token
    assert moe[1] - dense[1] == pytest.approx(
        (hit - 1) * w_ffn * 2 + 256 * 4 * 4 * 2)


def test_int8_asym_and_tied_bf16_bytes():
    tied = dict(SHAPE, tie_word_embeddings=True)
    tr = costs.trunk(tied, "int8asym")
    # int8 + an f32 scale and an f32 zero point a group
    assert tr["attn_bytes"] == 256 * 512 + 2 * 512 * 8 + 256 * 256 \
        + 2 * 256 * 8
    assert tr["head_bytes"] == 256 * 1000 * 2 and tr["embed_row_bytes"] == 512


def test_rooflines_and_mfu():
    assert costs.least_seconds(989e9, 1e9, PEAKS) == (1e-3, "ops")
    assert costs.least_seconds(1e9, 3.35e9, PEAKS) == (1e-3, "bytes")
    ctx = SimpleNamespace(
        peaks=PEAKS, slice_s=4.0,
        trace={"by_span": {"model.target_verify": 0.004,
                           "model.draft": 0.002, "linear.route_a": 0.5},
               "device_s": 2.0, "busy_s": 1.0},
        work={"verify": [(989e9, 1e9)] * 2, "draft": [(1e9, 3.35e9)],
              "prefill": [(989e9 * 2, 0.0)]},
        spans={"server.admit": (3, 1.0), "pool.block": (4, 2.0)})
    assert reader("kernels.verify_roofline")(ctx) == pytest.approx(50.0)
    assert reader("kernels.draft_roofline")(ctx) == pytest.approx(50.0)
    assert reader("model.mfu")(ctx) == pytest.approx(
        100 * (4 * 989e9 + 1e9) / (4.0 * 989e12))
    assert reader("linear.route_a_share")(ctx) == pytest.approx(25.0)
    assert reader("device.idle_share")(ctx) == pytest.approx(75.0)
    assert reader("server.prefill_share")(ctx) == pytest.approx(25.0)
    assert reader("pool.block_ms")(ctx) == pytest.approx(500.0)
    ctx.trace = None
    for name in ("kernels.verify_roofline", "linear.route_a_share",
                 "device.idle_share"):
        assert reader(name)(ctx) is None


def test_trace_reduction_credits_launches_to_spans():
    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e
    events = [x("cpu_op", "aten::x", 0, 500),
              x("user_annotation", "pool.block", 0, 100),
              x("user_annotation", "model.draft", 10, 30),
              x("user_annotation", "linear.route_a", 200, 50),
              x("cuda_runtime", "cudaLaunchKernel", 15, 1, 1),
              x("cuda_runtime", "cudaLaunchKernel", 60, 1, 2),
              x("cuda_runtime", "cudaLaunchKernel", 210, 1, 3),
              x("cuda_runtime", "cudaLaunchKernel", 400, 1, 4),
              x("kernel", "k_a", 20, 10, 1), x("kernel", "k_b", 70, 20, 2),
              x("kernel", "k_a", 220, 30, 3), x("gpu_memcpy", "copy", 410, 5,
                                                4)]
    r = trace.reduce({"traceEvents": events},
                     ("pool.block", "model.draft", "linear.route_a"))
    us = 1e-6
    assert r["by_span"] == pytest.approx({"model.draft": 10 * us,
                                          "pool.block": 30 * us,
                                          "linear.route_a": 30 * us})
    assert r["busy_s"] == pytest.approx(65 * us)
    assert r["device_s"] == pytest.approx(65 * us)
    assert dict(r["device_ops"]) == pytest.approx({"k_a": 40 * us,
                                                   "k_b": 20 * us,
                                                   "copy": 5 * us})
    assert dict(r["idle_gaps"]) == pytest.approx({
        "pool.block": 150 * us, "linear.route_a": 160 * us,
        "model.draft": 40 * us, "outside spans": 85 * us})
    assert trace.reduce({"traceEvents": events[:8]}, ("pool.block",)) is None


def test_slots_drawn_from_the_seed_keep_the_longest():
    lengths = [5] * 32
    lengths[17] = 900
    live = [True] * 32
    a = cell.choose_slots(7, 32, 6, lengths, live)
    assert a == cell.choose_slots(7, 32, 6, lengths, live)
    assert 17 in a and len(a) == 6
    bounds = [0, 5, 10, 16, 21, 26, 32]
    assert all(lo <= s < hi for s, lo, hi in zip(a, bounds, bounds[1:]))
