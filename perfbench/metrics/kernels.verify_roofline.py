"""kernels.verify_roofline (%): the least time the chip needs for the
traced slice's target verify forwards (each forward's larger of ops / bf16
peak and bytes / HBM peak, `harness/costs.py`: both trunks, int4 weights at
their packed size with scales, KV over the committed lengths, MoE at the
routed top-k), over the device time of the kernels launched inside them,
whatever kernels carry the work."""
from perfbench.harness import costs


def read(ctx):
    t = ctx.trace
    dev = None if t is None else t["by_span"].get("model.target_verify")
    if not dev or ctx.peaks is None or not ctx.work["verify"]:
        return None
    least = sum(costs.least_seconds(o, b, ctx.peaks)[0]
                for o, b in ctx.work["verify"])
    return 100.0 * least / dev
