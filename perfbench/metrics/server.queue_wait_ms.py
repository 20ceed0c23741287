"""server.queue_wait_ms (ms): the mean, over the admissions of the traced
slice (into a slot or the refill stock), of a request's wait from its
submission to the start of its prefill; the program's recorder stamps
both (`Request.submitted`, `SlotScheduler._admit` / `._stage`)."""
from perfbench.harness import recorder


def read(ctx):
    snap = recorder.snapshot()
    waits = [r["prefill"] - r["submitted"]
             for r in (snap or {}).get("requests", {}).values()
             if "prefill" in r]
    return 1e3 * sum(waits) / len(waits) if waits else None
