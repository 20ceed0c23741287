"""kernels.draft_roofline (%): the same as kernels.verify_roofline for the
draft's forward steps (the int8 draft's products at their int8 size with
scales, and zero points where the draft is asymmetric, its tied bf16 head,
KV over the committed lengths), over the device time of the kernels
launched inside the draft spans."""
from perfbench.harness import costs


def read(ctx):
    t = ctx.trace
    dev = None if t is None else t["by_span"].get("model.draft")
    if not dev or ctx.peaks is None or not ctx.work["draft"]:
        return None
    least = sum(costs.least_seconds(o, b, ctx.peaks)[0]
                for o, b in ctx.work["draft"])
    return 100.0 * least / dev
