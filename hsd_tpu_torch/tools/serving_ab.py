"""Phase 5g of `chip_smoke.py`, slot serving, for one or more checkouts of
the repository in turns, on one CUDA card: `SlotEngine` in bench.py's
serving configuration (8 slots, hsd, gamma 5, 16 requests) on the coupled
pair's int8 0.5B draft and bf16 0.5B trunk, then that checkout's
`trace_serving` (each part of the pool timed apart between synchronizes:
pool blocks, forwards, the verifier, the noise draws, the prefills, the
refill's merges; one pool block under the profiler).

    python hsd_tpu_torch/tools/serving_ab.py --roots A B B A [--reps 3]
        [--profile]

Each root runs in a process of its own and imports that checkout's own
`chip_smoke.py`, so it runs that checkout's server on its own kernels. The
14B half of the pair is built at one layer (the serving phase never calls
it; the draft and the trunk are the full-width ones of phase 5g). A
process prints the checkout's log lines and one JSON line: per rep the
untimed serving run's BE, tok/s, pool blocks, steps, host reads and
refills, and the streams' sha256; with --profile, one more run under
torch.profiler: its wall, device busy time, host ops issued and the ops
that took the most host time. The last line is each root's tok/s in
turn. Imports torch only.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time


def profiled(S, torch, draft, small, cfg_s, reqs) -> dict:
    """One untimed serving run under the profiler: wall ms, device busy
    ms, host ops, and the 12 ops with the most self host time."""
    from torch.profiler import ProfilerActivity, profile
    se, _ = S.serving_engine(draft, small, cfg_s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        S.serve(se, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)) for e in ev)
    host = sorted(ev, key=lambda e: e.self_cpu_time_total, reverse=True)
    out = dict(wall_ms=wall * 1e3, device_ms=dev_us / 1e3,
               host_ops=sum(e.count for e in ev
                            if e.self_cpu_time_total > 0),
               top=[(e.key, e.count, round(e.self_cpu_time_total / 1e3, 2))
                    for e in host[:12]])
    S.log(f"profiled serving run: {out}")
    return out


def worker(root: str, reps: int, prof: bool) -> dict:
    sys.path.insert(0, root)
    import torch
    import chip_smoke as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S.FD.FLASH_DECODE = S.FD.FUSED_ATTN = "auto"
    S._build.lib("gptq_i8")
    cfg_s = S.ModelConfig.qwen2_05b()
    cfg_b = dataclasses.replace(S.ModelConfig.qwen2_14b(), num_layers=1)
    draft, target = S.build_coupled_pair(0, cfg_s, cfg_b, lam=0.0,
                                         logit_scale=S.LOGIT_SCALE,
                                         device=S.DEV)
    small = target.small
    reqs = S.BM.serving_requests(cfg_s.vocab_size)[:S.SERVING_REQS]
    runs = []
    for _ in range(reps):
        se, _ = S.serving_engine(draft, small, cfg_s)
        before = {k: getattr(se, k, 0) for k in
                  ("steps", "pool_blocks", "host_reads", "refilled_total")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = S.serve(se, reqs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_tok = sum(len(r.out_tokens) for r in served.values())
        blocks = sum(r.blocks for r in served.values())
        streams = sorted((rid, r.out_tokens) for rid, r in served.items())
        runs.append(dict(
            {k: getattr(se, k, 0) - v for k, v in before.items()},
            be=(sum(r.accepts for r in served.values()) + blocks) / blocks,
            tok_s=n_tok / secs, secs=secs, tokens=n_tok,
            sha=hashlib.sha256(str(streams).encode()).hexdigest()[:16]))
        S.log(f"serving rep: {runs[-1]}")
    S.trace_serving(draft, small, cfg_s, reqs)
    out = {"root": root, "device": torch.cuda.get_device_name(0),
           "runs": runs}
    if prof:
        out["profiled"] = profiled(S, torch, draft, small, cfg_s, reqs)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs="+",
                    default=[os.path.dirname(os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.reps, args.profile)),
              flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rows = []
    for root in args.roots:
        root = os.path.abspath(root)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", root,
             "--reps", str(args.reps)]
            + (["--profile"] if args.profile else []),
            capture_output=True, text=True, cwd=root)
        print(out.stdout, flush=True)
        print(out.stderr[-6000:], file=sys.stderr, flush=True)
        if out.returncode:
            sys.exit(f"{root}: exit {out.returncode}")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        rows.append({"root": root,
                     "tok_s": [r["tok_s"] for r in res["runs"]],
                     "be": res["runs"][0]["be"], "sha": res["runs"][0]["sha"]})
    print(json.dumps({"in_turns": rows}), flush=True)


if __name__ == "__main__":
    main()
