"""server.prefix_recompute_share (%): of the prompt tokens the traced
slice's admissions prefilled, the share that repeats the start of the
prompt admitted just before (the longest common prefix of the unpadded
prompts; the program's counters server.prefix_tokens /
server.prompt_tokens): a lower bound on what a prefix cache would not
recompute."""
from perfbench.harness import recorder


def read(ctx):
    snap = recorder.snapshot()
    c = {} if snap is None else snap["counters"]
    tokens = c.get("server.prompt_tokens")
    return 100.0 * c.get("server.prefix_tokens", 0) / tokens if tokens \
        else None
