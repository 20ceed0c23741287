"""The traced slice of the window: `torch.profiler` over CPU and CUDA
activity, exported as a Chrome trace and reduced here.

A device event (kernel, memcpy, memset) is credited to every span
(`record_function` range) that encloses its host launch, found through the
launch's correlation id: the harness's spans (`instrument.SPANS`) and the
program's own (`hsd_tpu_torch/utils/profiling.py`) alike, once a name
however many ranges of that name enclose it. Every kernel name keeps its
device seconds and launch count. Busy time is the union of the device
events; idle gaps are the rest of the slice, each credited to the
innermost of the harness's spans the host was in when the gap began.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Dict, List, Optional

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def export(prof) -> dict:
    """The profiler's Chrome trace, read back from a temporary file (under
    TMPDIR) that is removed at once."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def reduce(trace: dict, spans) -> Optional[dict]:
    """{"busy_s", "device_s", "by_span": {range name: device s}, "by_op":
    {kernel name: (device s, launches)}, "device_ops": [[name, s]] (top 10),
    "idle_gaps": [[span, s]] (top 10, over `spans`)}, or None when the trace
    holds no device event."""
    evs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS]
    if not dev:
        return None
    launch = {}
    for e in evs:
        if e.get("cat") in LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch[c] = float(e["ts"])
    ann: Dict[str, List[tuple]] = collections.defaultdict(list)
    for e in evs:
        if e.get("cat") == "user_annotation":
            ann[e["name"]].append((float(e["ts"]),
                                   float(e["ts"]) + float(e["dur"])))
    starts = {}
    for k, iv in ann.items():
        iv.sort()
        starts[k] = [a for a, _ in iv]

    by_op = collections.Counter()
    calls = collections.Counter()
    intervals, durs, launched = [], [], []
    for e in dev:
        d = float(e.get("dur", 0.0))
        intervals.append((float(e["ts"]), float(e["ts"]) + d))
        durs.append(d)
        by_op[e["name"]] += d
        calls[e["name"]] += 1
        t = launch.get((e.get("args") or {}).get("correlation"))
        launched.append(np.nan if t is None else t)
    durs_a, t_a = np.array(durs), np.array(launched)
    by_span = {}
    for name, iv in ann.items():
        union = _union(iv)
        i = np.searchsorted(np.array([a for a, _ in union]), t_a,
                            side="right") - 1
        ends = np.array([b for _, b in union])
        inside = (i >= 0) & (ends[np.maximum(i, 0)] >= t_a)
        if inside.any():
            # summed in the trace's order of device events
            by_span[name] = sum(durs_a[inside].tolist())
    merged = _union(intervals)
    busy = sum(b - a for a, b in merged)
    host = [e for e in evs if e.get("cat") in ("user_annotation",)
            + LAUNCH_CATS or e.get("cat") == "cpu_op"]
    t0 = min(min(float(e["ts"]) for e in host), merged[0][0]) if host \
        else merged[0][0]
    t1 = max(max(float(e["ts"]) + float(e["dur"]) for e in host),
             merged[-1][1]) if host else merged[-1][1]
    own = {k: iv for k, iv in ann.items() if k in spans}
    gaps = collections.Counter()
    prev = t0
    for a, b in merged + [[t1, t1]]:
        if a > prev:
            gaps[_innermost(own, starts, prev)] += a - prev
        prev = max(prev, b)
    us = 1e-6
    return {"busy_s": busy * us, "device_s": sum(by_op.values()) * us,
            "by_span": {k: v * us for k, v in by_span.items()},
            "by_op": {k: (v * us, calls[k]) for k, v in by_op.items()},
            "device_ops": [[n, v * us] for n, v in by_op.most_common(10)],
            "idle_gaps": [[n, v * us] for n, v in gaps.most_common(10)]}


def _union(intervals) -> List[list]:
    """Sorted, disjoint [start, end] covering the (start, end) given."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(ann, starts, t) -> str:
    best, best_start = "outside spans", None
    for name, iv in ann.items():
        i = bisect.bisect_right(starts[name], t) - 1
        if i >= 0 and iv[i][1] >= t and (best_start is None
                                          or iv[i][0] > best_start):
            best, best_start = name, iv[i][0]
    return best
