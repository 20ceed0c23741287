"""The readings that the limits of `correct` are set from: the program's
numbers on many seeds, the control's (the float32 reference's float8 twin
in the program's place, `harness/check.control`) on the same captured
blocks, and the planted faults' (`harness/faults.py`) at the cell's size.
The benchmark's own runs never run this.

    python3 perfbench/control.py --workload qwen2.5-14b.gsm8k \
        --seeds 11,12,13 --seconds 10

Each seed is a full run of the cell (its own weights, warm-up and a short
window at the cell's load) in this one process, with the harvest's fault
planted for the whole run and the other faults each planted after the
window for blocks of their own. Each prints one JSON line {"seed",
"program": the sound capture's numbers, "harvest_off": the harvest
fault's reading, "control": numbers, "faults": {fault: numbers}}.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from perfbench.harness import cell, check, discover, faults

    if not torch.cuda.is_available():
        sys.exit("perfbench control: no CUDA device")
    bench = discover.Bench(ROOT, PKG)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        post = {k: f for k, f in faults.FAULTS.items()
                if k != "harvest_altered"}
        out = cell.run_cell(bench, args.workload, seed, args.seconds, False,
                            "cuda", t0, fault=faults.harvest_altered,
                            post_faults=post)
        ctrl = check.control(out["served"], out["temperature"],
                             out["records"], out["refl"], "cuda")
        drop = ("detail",)
        print(json.dumps({
            "seed": seed,
            "program": {k: v for k, v in out["numbers"].items()
                        if k not in drop},
            "harvest_off": out["numbers"]["harvest_off"],
            "control": {k: v for k, v in ctrl.items() if k not in drop},
            "faults": {n: {k: v for k, v in f.items() if k not in drop}
                       for n, f in out["faults"].items()},
            "seconds": time.perf_counter() - t0,
            "info": out["info"]}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
