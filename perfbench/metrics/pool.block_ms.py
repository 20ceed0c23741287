"""pool.block_ms (ms): wall time a pool block (SlotPool.block, the device
synchronized at both ends), over the blocks of the traced slice."""


def read(ctx):
    n, seconds = ctx.spans["pool.block"]
    return 1e3 * seconds / n if n else None
