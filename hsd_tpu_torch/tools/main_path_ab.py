"""Phase 5 of `chip_smoke.py`, the speculative main path, for one or more
checkouts of the repository in turns, on one CUDA card: make_generate with
hsd and tokenwise (gamma 10, K 1) on the 48-layer 14B-geometry packed-int4
target and the asymmetric-int8 0.5B draft, 3 prompts of bucket 64 and 128
new tokens each, then AR over 32 tokens and the full-width greedy prefix.

    python hsd_tpu_torch/tools/main_path_ab.py --roots A B B A [--trace]

Each root runs in a process of its own and imports that checkout's own
`chip_smoke.py`, so it runs that checkout's phase 5 code on its own
kernels (built from its own `csrc/`). A process prints the checkout's log
lines (with --trace also its profiled 56-token hsd windows and host costs)
and one JSON line: BE and tok/s by method, AR tok/s and the launch counts.
The last line is each root's tok/s in turn. Imports torch only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def worker(root: str, trace: bool) -> dict:
    sys.path.insert(0, root)
    import torch
    import chip_smoke as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S.FD.FLASH_DECODE = S.FD.FUSED_ATTN = "auto"
    cfg_s, cfg_b = S.ModelConfig.qwen2_05b(), S.ModelConfig.qwen2_14b()
    draft, target = S.build_coupled_pair(0, cfg_s, cfg_b, lam=0.0,
                                         logit_scale=S.LOGIT_SCALE,
                                         device=S.DEV)
    results, counts = S.main_path(draft, target, cfg_s, cfg_b, trace)
    return {"root": root, "device": torch.cuda.get_device_name(0),
            "hsd": results["hsd"], "tokenwise": results["tokenwise"],
            "ar_tok_s": results["ar_tok_s"], "launches": counts}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs="+",
                    default=[os.path.dirname(os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))])
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.trace)), flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rows = []
    for root in args.roots:
        root = os.path.abspath(root)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", root]
            + (["--trace"] if args.trace else []),
            capture_output=True, text=True, cwd=root)
        print(out.stdout, flush=True)
        if out.returncode:
            sys.exit(f"{root}: exit {out.returncode}\n{out.stderr[-4000:]}")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        rows.append({"root": root, "hsd_tok_s": res["hsd"]["tok_s"],
                     "hsd_be": res["hsd"]["be"],
                     "tokenwise_tok_s": res["tokenwise"]["tok_s"],
                     "tokenwise_be": res["tokenwise"]["be"],
                     "ar_tok_s": res["ar_tok_s"]})
    print(json.dumps({"in_turns": rows}), flush=True)


if __name__ == "__main__":
    main()
