"""device.idle_share (%): 1 - device busy / wall over the traced slice,
busy being the union of every kernel, copy and set on the device. An upper
bound: the profiler lengthens the wall."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.slice_s:
        return None
    return 100.0 * (1.0 - t["busy_s"] / ctx.slice_s)
