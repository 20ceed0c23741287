"""linear.route_a_share (%): device time of the kernels launched inside
route-A spans (ops.linear.dequant_matmul, dequantize-then-dot) over the
device time of every kernel in the traced slice."""


def read(ctx):
    t = ctx.trace
    if t is None or not t["device_s"]:
        return None
    return 100.0 * t["by_span"].get("linear.route_a", 0.0) / t["device_s"]
