"""pool.verify_ms (ms): the stream time a pool block spends in the
verifier (the program's pool.verify span: its CUDA event pair around the
vmapped verifier), over the traced slice's blocks."""
from perfbench.harness import recorder


def read(ctx):
    got = recorder.device_s("pool.verify")
    return None if not got or not got[0] else 1e3 * got[1] / got[0]
