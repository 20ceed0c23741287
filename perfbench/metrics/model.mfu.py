"""model.mfu (%): the operations the traced slice's forwards need (target
verifies, draft steps and admissions' prefills; MoE at the routed top-k;
`harness/costs.py`) over the slice's seconds times the bf16 peak."""


def read(ctx):
    if ctx.peaks is None or not ctx.slice_s:
        return None
    ops = sum(o for kind in ("verify", "draft", "prefill")
              for o, _ in ctx.work[kind])
    return 100.0 * ops / (ctx.slice_s * ctx.peaks["bf16_flops_per_s"])
