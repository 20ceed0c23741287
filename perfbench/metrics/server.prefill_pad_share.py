"""server.prefill_pad_share (%): of the rows the traced slice's admissions
ran through their target and draft prefill forwards (R x ((P - 1) +
(P - 2)) an admission at bucket P), the share that holds only left padding
(the program's counters server.prefill_pad_rows / server.prefill_rows)."""
from perfbench.harness import recorder


def read(ctx):
    snap = recorder.snapshot()
    c = {} if snap is None else snap["counters"]
    rows = c.get("server.prefill_rows")
    return 100.0 * c.get("server.prefill_pad_rows", 0) / rows if rows \
        else None
