"""Profiling / tracing utilities (port of `hsd_tpu/utils/profiling.py`).

The reference's instrumentation is a cuda-sync Timer context manager and
per-stage wall-clock dicts serialized to _info.jsonl (EAGLE
eagle/model/utils.py:24-35, ea_model.py:207-361). Here:

  * Timer: a stage timer that synchronizes the device of its `sync`
    tensor(s) before reading the clock (host-visible wall clock);
  * trace(): a torch.profiler window written as a chrome trace;
  * StageClock: accumulates named stage durations across a run and emits the
    reference's stage-dict shape for _info.jsonl rows.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List

import torch


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


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler window (the card's kernels too, when there is one),
    written to `logdir`/trace.json for chrome://tracing or perfetto.
    Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StageClock:
    """Accumulate per-stage timings; emit the reference's stage-dict shape."""

    def __init__(self):
        self.stages: Dict[str, List[float]] = defaultdict(list)

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
