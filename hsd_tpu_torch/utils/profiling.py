"""Profiling / tracing utilities (port of `hsd_tpu/utils/profiling.py`), and
the port's recorder of spans and counters.

The reference's instrumentation is a cuda-sync Timer context manager and
per-stage wall-clock dicts serialized to _info.jsonl (EAGLE
eagle/model/utils.py:24-35, ea_model.py:207-361). Here:

  * Timer: a stage timer that synchronizes the device of its `sync`
    tensor(s) before reading the clock (host-visible wall clock);
  * trace(): a torch.profiler window written as a chrome trace, with the
    recorder's snapshot beside it;
  * StageClock: accumulates named stage durations across a run and emits the
    reference's stage-dict shape for _info.jsonl rows; it is also the
    recorder, and `RECORDER` is the instance the engines write to through
    the module's `span`, `count`, `admitted` and `harvested`.

The recorder records while a torch profiler window is open (`trace()`, or
any caller's `torch.profiler.profile`), and only then. Off, `span(name)`
returns one shared no-op context after a single flag read, and the other
calls return at once. On, a span is a `record_function` range, so it lands
in the profiler's Chrome trace on the CUDA kernels' clock, nested under its
parent span, and each name keeps its calls, host seconds and self seconds
(less its child spans). A span opened with `device=True` also records a
CUDA event pair on the current stream; `snapshot()` resolves the pairs,
after one synchronize, into stream seconds.

Counters (`count`): server.admissions, server.prompt_tokens and
server.prefix_tokens (the longest common prefix of an admitted prompt with
the one admitted before it; both unpadded), server.prefill_rows and
server.prefill_pad_rows (the rows an admission's forwards run, and of them
the ones that hold only left padding). Requests (`admitted`, `harvested`):
rid -> {"submitted", "prefill", "harvest"} host-clock times.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List

import torch
from torch.autograd import profiler as _autograd_profiler


def synchronize(sync) -> None:
    """Wait for the device work behind `sync`: a tensor, or a (nested)
    list / tuple / dict of them. CPU tensors need no wait."""
    if sync is None:
        return
    if isinstance(sync, torch.Tensor):
        if sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        return
    items = sync.values() if isinstance(sync, dict) else sync
    for s in items:
        synchronize(s)


class Timer:
    """with Timer("draft", sync=t): ... — synchronizes like the reference's
    torch.cuda.synchronize Timer (EAGLE utils.py:24-35)."""

    def __init__(self, name: str = "", sync=None, verbose: bool = False):
        self.name = name
        self.sync = sync            # optional tensor(s) to wait for
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        synchronize(self.sync)
        self.elapsed = time.perf_counter() - self.t0
        if self.verbose:
            print(f"[{self.name}] {self.elapsed*1e3:.2f} ms")
        return False


class _Off:
    """The span of a recorder that is off: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """One open span: a record_function range, host-clock totals, and with
    `device` a CUDA event pair on the current stream."""
    __slots__ = ("clock", "name", "device", "range", "events", "stream",
                 "t0", "child")

    def __init__(self, clock: "StageClock", name: str, device: bool):
        self.clock, self.name, self.device = clock, name, device
        self.events = None
        self.child = 0.0

    def __enter__(self):
        self.clock._open.append(self)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        if self.device and torch.cuda.is_initialized():
            self.events = self.clock._event_pair()
            self.stream = torch.cuda.current_stream()
            self.events[0].record(self.stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host = time.perf_counter() - self.t0
        if self.events is not None:
            self.events[1].record(self.stream)
        self.range.__exit__(*exc)
        clock = self.clock
        clock._open.pop()
        if clock._open:
            clock._open[-1].child += host
        tot = clock.spans[self.name]
        tot[0] += 1
        tot[1] += host
        tot[2] += host - self.child
        if self.events is not None:
            clock._pending.append((self.name,) + self.events)
        return False


class StageClock:
    """Accumulate per-stage timings; emit the reference's stage-dict shape.
    Also the recorder of spans, counters and requests (module docstring)."""

    def __init__(self):
        self.stages: Dict[str, List[float]] = defaultdict(list)
        self._open: List[_Span] = []
        self._events: list = []      # resolved CUDA event pairs, reused
        self.reset()

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        synchronize(sync)
        self.stages[name].append(time.perf_counter() - t0)

    def row(self) -> Dict[str, List[List[float]]]:
        """One _info.jsonl-shaped record (gen_ea_answer:489-533)."""
        return {f"{k}_time": [v] for k, v in self.stages.items()}

    def totals(self) -> Dict[str, float]:
        return {k: sum(v) for k, v in self.stages.items()}

    # ---- the recorder
    def span(self, name: str, device: bool = False):
        """with clock.span(name): ... — a span while a profiler window is
        open, else the shared no-op."""
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        return _Span(self, name, device)

    def count(self, name: str, n: int = 1):
        if _autograd_profiler._is_profiler_enabled:
            self.counters[name] += n

    def admitted(self, rid: int, submitted: float, prompt: List[int],
                 prompt_len: int):
        """A request's prefill starts: the admission counters, and its
        record's submission and prefill times. prompt: left-padded."""
        if not _autograd_profiler._is_profiler_enabled:
            return
        ids = prompt[len(prompt) - prompt_len:]
        last = self._last_prompt
        k, n = 0, min(len(ids), len(last))
        while k < n and ids[k] == last[k]:
            k += 1
        c = self.counters
        c["server.admissions"] += 1
        c["server.prompt_tokens"] += prompt_len
        c["server.prefix_tokens"] += k
        self._last_prompt = ids
        self.requests[rid] = {"submitted": submitted,
                              "prefill": time.perf_counter()}

    def harvested(self, rid: int, submitted: float):
        """A finished request's output is harvested."""
        if not _autograd_profiler._is_profiler_enabled:
            return
        rec = self.requests.setdefault(rid, {"submitted": submitted})
        rec["harvest"] = time.perf_counter()

    def _event_pair(self):
        if self._events:
            return self._events.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def snapshot(self) -> dict:
        """{"spans": {name: {"calls", "host_s", "self_s"[, "device_s"]}},
        "counters": {name: n}, "requests": {rid: {...}}}; the device spans'
        event pairs are resolved first, after one synchronize."""
        if self._pending:
            torch.cuda.synchronize()
            for name, e0, e1 in self._pending:
                self.device_s[name] += e0.elapsed_time(e1) * 1e-3
                self._events.append((e0, e1))
            self._pending = []
        spans = {}
        for name, (calls, host, own) in self.spans.items():
            spans[name] = {"calls": calls, "host_s": host, "self_s": own}
            if name in self.device_s:
                spans[name]["device_s"] = self.device_s[name]
        return {"spans": spans, "counters": dict(self.counters),
                "requests": {r: dict(v) for r, v in self.requests.items()}}

    def reset(self):
        """Forget every span, counter and request recorded."""
        self.spans: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])
        self.device_s: Dict[str, float] = defaultdict(float)
        self.counters: Dict[str, int] = defaultdict(int)
        self.requests: Dict[int, dict] = {}
        self._pending: list = []
        self._last_prompt: List[int] = []


RECORDER = StageClock()
span = RECORDER.span
count = RECORDER.count
admitted = RECORDER.admitted
harvested = RECORDER.harvested
snapshot = RECORDER.snapshot
reset = RECORDER.reset


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler window (the card's kernels too, when there is one),
    written to `logdir`/trace.json for chrome://tracing or perfetto, and
    the recorder's snapshot of the window to `logdir`/spans.json. Yields
    the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(snapshot(), f, indent=1)
