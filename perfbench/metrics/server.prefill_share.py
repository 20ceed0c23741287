"""server.prefill_share (%): the traced slice's wall time inside admission
spans (SlotPool.prefill and .stage, the device synchronized at both ends
of each), over the slice's wall time."""


def read(ctx):
    n, seconds = ctx.spans["server.admit"]
    return 100.0 * seconds / ctx.slice_s if ctx.slice_s else None
