"""The program's own recorder (`hsd_tpu_torch.utils.profiling`) as the
per-layer readers read it. It records only while a profiler window is
open, which in a traced run is the traced slice alone, so its snapshot is
the slice's."""
from __future__ import annotations

from typing import Optional

from hsd_tpu_torch.utils import profiling


def snapshot() -> Optional[dict]:
    """The recorder's snapshot ({"spans", "counters", "requests"}), or None
    where the program has no recorder or it recorded nothing."""
    read = getattr(profiling, "snapshot", None)
    if read is None:
        return None
    snap = read()
    return snap if any(snap.values()) else None


def device_s(name: str) -> Optional[tuple]:
    """(calls, stream seconds) of a device span, or None where it has no
    CUDA events (no span, or no card)."""
    snap = snapshot()
    span = None if snap is None else snap["spans"].get(name)
    if not span or "device_s" not in span:
        return None
    return span["calls"], span["device_s"]
