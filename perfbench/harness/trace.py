"""The traced slice of the window: `torch.profiler` over CPU and CUDA
activity, exported as a Chrome trace and reduced here.

A device event (kernel, memcpy, memset) is credited to every span
(`record_function` range) that encloses its host launch, found through the
launch's correlation id. Busy time is the union of the device events;
idle gaps are the rest of the slice, each credited to the innermost span
the host was in when the gap began.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Dict, List, Optional

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
    """{"busy_s", "device_s", "by_span": {span: device s}, "device_ops":
    [[name, s]] (top 10), "idle_gaps": [[span, s]] (top 10)}, or None when
    the trace holds no device event."""
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
        if e.get("cat") == "user_annotation" and e["name"] in spans:
            ann[e["name"]].append((float(e["ts"]),
                                   float(e["ts"]) + float(e["dur"])))
    starts = {}
    for k, iv in ann.items():
        iv.sort()
        starts[k] = [a for a, _ in iv]

    def inside(name, t):
        i = bisect.bisect_right(starts[name], t) - 1
        return i >= 0 and ann[name][i][1] >= t

    by_span = collections.Counter()
    by_op = collections.Counter()
    intervals = []
    for e in dev:
        d = float(e.get("dur", 0.0))
        intervals.append((float(e["ts"]), float(e["ts"]) + d))
        by_op[e["name"]] += d
        t = launch.get((e.get("args") or {}).get("correlation"))
        if t is None:
            continue
        for name in ann:
            if inside(name, t):
                by_span[name] += d
    intervals.sort()
    merged = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    host = [e for e in evs if e.get("cat") in ("user_annotation",)
            + LAUNCH_CATS or e.get("cat") == "cpu_op"]
    t0 = min(min(float(e["ts"]) for e in host), merged[0][0]) if host \
        else merged[0][0]
    t1 = max(max(float(e["ts"]) + float(e["dur"]) for e in host),
             merged[-1][1]) if host else merged[-1][1]
    gaps = collections.Counter()
    prev = t0
    for a, b in merged + [[t1, t1]]:
        if a > prev:
            gaps[_innermost(ann, starts, prev)] += a - prev
        prev = max(prev, b)
    us = 1e-6
    return {"busy_s": busy * us, "device_s": sum(by_op.values()) * us,
            "by_span": {k: v * us for k, v in by_span.items()},
            "device_ops": [[n, v * us] for n, v in by_op.most_common(10)],
            "idle_gaps": [[n, v * us] for n, v in gaps.most_common(10)]}


def _innermost(ann, starts, t) -> str:
    best, best_start = "outside spans", None
    for name, iv in ann.items():
        i = bisect.bisect_right(starts[name], t) - 1
        if i >= 0 and iv[i][1] >= t and (best_start is None
                                          or iv[i][0] > best_start):
            best, best_start = name, iv[i][0]
    return best
