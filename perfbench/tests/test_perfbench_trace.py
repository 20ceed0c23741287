"""The device trace's reduction (`harness/trace.py`) on Chrome traces
written here: device time for every profiler range, the program's own
spans among them, and for every kernel by name; and, on a trace shaped
like a traced slice of the cell (harness spans around the program's spans
of the same names, more kernel names than the top ten), the keys that the
result line and the per-layer readers read are the ones the harness gave
before it read the program's spans (frozen below)."""
import random

import pytest

from perfbench.harness import trace
from perfbench.harness.instrument import SPANS

US = 1e-6


def x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


class Slice:
    """A host timeline of nested ranges and kernel launches, and the device
    running the launched kernels in order."""

    def __init__(self, seed):
        self.rng = random.Random(seed)
        self.t, self.free, self.corr, self.ev = 0.0, 0.0, 0, []

    def launch(self, kernel, dur, cat="kernel"):
        self.corr += 1
        self.ev.append(x("cuda_runtime", "cudaLaunchKernel", self.t, 2.0,
                         self.corr))
        start = max(self.t + 3.0, self.free)
        self.ev.append(x(cat, kernel, start, dur, self.corr))
        self.free = start + dur
        self.t += 4.0 + self.rng.randint(0, 6)

    def span(self, name, body, twin=False, after=None):
        """A range around body(); twin: the program's range of the same
        name inside it, holding body's launches; after(): launches in this
        range once the twin has closed."""
        t0 = self.t
        self.t += 1.0
        if twin:
            self.span(name, body)
        else:
            body()
        if after is not None:
            after()
        self.t += 1.0
        self.ev.append(x("user_annotation", name, t0, self.t - t0))
        self.t += self.rng.randint(0, 150)         # host work: an idle gap

    def kernels(self, names, n):
        for _ in range(n):
            self.launch(self.rng.choice(names),
                        float(self.rng.randint(2, 60)))


def cell_like(seed=3, capture=False):
    """Three steps, each two admissions (a target prefill of route-A
    products, each a dequantize and a GEMM) and a block (draft steps, a
    verify, the program's verifier and commit spans): eighteen kernel
    names and a copy, one kernel with no launch. capture: a copy of the
    harness's own in each block's harness range, after the program's
    range of that name closed."""
    s = Slice(seed)
    gemm = [f"gemm_{i}" for i in range(6)]
    small = [f"elementwise_{i}" for i in range(6)]

    def route_a():
        s.span("linear.dequant", lambda: s.launch("dequant_kernel", 9.0))
        s.launch(s.rng.choice(gemm), float(s.rng.randint(20, 90)))

    def prefill():
        for _ in range(4):
            s.span("linear.route_a", route_a, twin=True)
        s.kernels(small, 3)

    def admit():
        s.span("model.target_prefill", prefill, twin=True)
        s.span("model.draft_prefill", lambda: s.kernels(small + gemm, 4))
        s.span("pool.cache_put",
               lambda: s.launch("copy", 5.0, cat="gpu_memcpy"))

    def block():
        s.span("model.draft", lambda: s.kernels(small + ["i8_kernel"], 8),
               twin=True)
        s.span("model.target_verify",
               lambda: s.kernels(["i4_kernel"] + small, 6), twin=True)
        s.span("pool.verify", lambda: s.kernels(["verify_kernel"], 2))
        s.span("pool.commit", lambda: s.kernels(small, 3))

    def step():
        for _ in range(2):
            s.span("server.admit", admit, twin=True)
        s.span("pool.block", block, twin=True, after=(lambda: s.launch(
            "capture_copy", 6.0, cat="gpu_memcpy")) if capture else None)
        s.span("server.noise", lambda: s.kernels(["philox"], 1))

    for _ in range(3):
        s.span("server.step", step, twin=True)
    s.ev.append(x("kernel", "unlaunched", s.free + 10.0, 4.0, 10 ** 6))
    s.ev.append(x("cpu_op", "aten::whole", 0.0, s.t))
    return {"traceEvents": s.ev}


# trace.reduce of the harness before it read the program's spans, on
# cell_like() with the harness's seven spans
BEFORE = {
    "busy_s": 0.0048649999999999995,
    "device_s": 0.0048649999999999995,
    "by_span": {"linear.route_a": 0.001606, "model.draft": 0.000628,
                "model.target_prefill": 0.002126,
                "model.target_verify": 0.0005729999999999999,
                "pool.block": 0.0016799999999999999,
                "server.admit": 0.003116, "server.step": 0.004861},
    "device_ops": [["elementwise_0", 0.000731], ["gemm_2", 0.000512],
                   ["elementwise_3", 0.000512], ["gemm_4", 0.000464],
                   ["gemm_1", 0.00037],
                   ["elementwise_4", 0.00033999999999999997],
                   ["gemm_0", 0.000263], ["elementwise_1", 0.000249],
                   ["gemm_5", 0.000245], ["elementwise_2", 0.000227]],
    "idle_gaps": [["model.target_prefill", 0.002843],
                  ["linear.route_a", 0.001849], ["server.admit", 0.001173],
                  ["server.step", 0.000799], ["pool.block", 0.000236],
                  ["outside spans", 0.00014]],
}


# the seven spans' by_span on cell_like(capture=True): the harness before
# credited a launch only to the latest-started range of a name, the program's
# pool.block, and missed the three copies after it closed (6 us each)
CAPTURE_BEFORE = {"linear.route_a": 0.001606, "model.draft": 0.000628,
                  "model.target_prefill": 0.002126,
                  "model.target_verify": 0.0005729999999999999,
                  "pool.block": 0.0016799999999999999,
                  "server.admit": 0.003116, "server.step": 0.004902}
CAPTURE_NOW = dict(CAPTURE_BEFORE, **{"pool.block": 0.0016979999999999999})


def test_program_span_and_kernel_outside_the_top_ten():
    events = [x("cpu_op", "aten::x", 0, 300),
              x("user_annotation", "pool.block", 0, 200),
              x("user_annotation", "pool.verify", 100, 50),    # the program's
              x("cuda_runtime", "cudaLaunchKernel", 10, 1, 1),
              x("cuda_runtime", "cudaLaunchKernel", 120, 1, 2)]
    events += [x("kernel", f"big_{i}", 20 + 5 * i, 5) for i in range(10)]
    events += [x("kernel", "k_verify", 130, 7, 2), x("kernel", "k_a", 15, 3,
                                                    1)]
    r = trace.reduce({"traceEvents": events}, SPANS)
    assert r["by_span"] == pytest.approx({"pool.block": 10 * US,
                                          "pool.verify": 7 * US})
    names = [n for n, _ in r["device_ops"]]
    assert len(names) == 10 and "k_verify" in names and "k_a" not in names
    assert r["by_op"]["k_a"] == pytest.approx((3 * US, 1))
    assert r["by_op"]["big_3"] == pytest.approx((5 * US, 1))
    # idle gaps stay credited over the harness's spans alone
    assert {n for n, _ in r["idle_gaps"]} <= set(SPANS) | {"outside spans"}


def test_a_launch_counts_once_for_every_range_of_its_name():
    """Nested ranges of one name (the harness's around the program's):
    a launch in the outer range after the inner one closed counts for the
    name, and one inside both counts once."""
    events = [x("user_annotation", "model.draft", 0, 100),
              x("user_annotation", "model.draft", 10, 20),
              x("cuda_runtime", "cudaLaunchKernel", 15, 1, 1),
              x("cuda_runtime", "cudaLaunchKernel", 60, 1, 2),
              x("kernel", "k", 20, 4, 1), x("kernel", "k", 70, 6, 2)]
    r = trace.reduce({"traceEvents": events}, SPANS)
    assert r["by_span"] == pytest.approx({"model.draft": 10 * US})
    assert r["by_op"]["k"] == pytest.approx((10 * US, 2))


def test_cell_like_slice_reads_as_before():
    r = trace.reduce(cell_like(), SPANS)
    assert r["busy_s"] == BEFORE["busy_s"]
    assert r["device_s"] == BEFORE["device_s"]
    assert {k: v for k, v in r["by_span"].items() if k in SPANS} == \
        BEFORE["by_span"]
    assert r["device_ops"] == BEFORE["device_ops"]
    assert r["idle_gaps"] == BEFORE["idle_gaps"]
    # the program's own spans are read too, and every kernel by name
    for name in ("linear.dequant", "pool.verify", "pool.commit",
                 "model.draft_prefill", "server.noise"):
        assert r["by_span"][name] > 0
    assert len(r["by_op"]) == 19
    assert sum(s for s, _ in r["by_op"].values()) == pytest.approx(
        r["device_s"])


def test_a_harness_launch_after_the_programs_range_of_its_name_counts():
    r = trace.reduce(cell_like(capture=True), SPANS)
    assert {k: v for k, v in r["by_span"].items() if k in SPANS} == \
        CAPTURE_NOW
    assert CAPTURE_NOW["pool.block"] - CAPTURE_BEFORE["pool.block"] == \
        pytest.approx(3 * 6.0 * US)
    assert r["by_op"]["capture_copy"] == pytest.approx((3 * 6.0 * US, 3))
