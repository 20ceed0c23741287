"""linear.dequant_share (%): the stream time of route A's dequantize (the
program's linear.dequant span: its CUDA event pair around `dequantize`
inside `ops.linear.dequant_matmul`) over the traced slice's seconds."""
from perfbench.harness import recorder


def read(ctx):
    got = recorder.device_s("linear.dequant")
    if not got or not ctx.slice_s:
        return None
    return 100.0 * got[1] / ctx.slice_s
