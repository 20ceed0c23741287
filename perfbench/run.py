"""The benchmark of the PyTorch port: one run of one cell on the card.

    python3 perfbench/run.py --workload qwen2.5-14b.gsm8k --seed 7 \
        --seconds 51 --trace 0

Run from the root of a checkout. The cell's pieces are found by name
(`harness/discover.py`); a run builds its pair on the card from the seed,
warms the closed loop up, measures for --seconds, checks what the timed
path produced against the plain reference, and prints one JSON line as
the last line of standard output: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with --trace 1 its per-layer
ones), `device` and, traced, `breakdown`, then `check` (each compared
number with its limit). The same numbers are the last lines of standard
error.

It exits non-zero, printing no result, where no card is present, where
there are fewer cards than the cell asks for, where the program or the
harness is missing from the checkout, or where jax, jaxlib, flax or the
JAX package is loaded once the window has closed. Every build and kernel
cache stays inside the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hsd_tpu")


def fail(msg: str, code: int = 2):
    print(f"perfbench: {msg}", file=sys.stderr)
    sys.exit(code)


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit():
    """The card's power limit in W (nvidia-smi), which the published peaks
    of `peaks.json` assume at 700 W; None where it cannot be read."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / ".perfbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    if not (ROOT / "hsd_tpu_torch").is_dir():
        fail("the program (hsd_tpu_torch/) is not in this checkout")

    import torch
    from perfbench.harness import cell, discover

    bench = discover.Bench(ROOT, PKG)
    wl = bench.workload(args.workload)
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < wl["chips"]:
        fail(f"{wl['chips']} cards needed, {torch.cuda.device_count()} "
             f"present")
    out = cell.run_cell(bench, args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", T_START)
    info = out["info"]
    print(f"perfbench: window {info['window_s']:.3f} s, {info['completed']} "
          f"requests completed in it (the p90's samples), {info['warm']} "
          f"before it; check on {info['records']} blocks of slots "
          f"{info['slots']}, ties {info['commit_ties']}, largest position "
          f"{info['maxima']}, reference law entropy "
          f"{info['target_entropy']} nats; harvests checked "
          f"{info['harvest_checked']}; traced blocks {info['blocks']}, "
          f"admissions {info['admissions']}, trace read in "
          f"{info['trace_reduce_s']:.1f} s, check run in "
          f"{info['check_s']:.1f} s", file=sys.stderr)
    for d in out["numbers"].get("detail", []):
        print(f"perfbench: check detail {json.dumps(d)}", file=sys.stderr)
    limit = power_limit()
    if limit is not None:
        out["result"]["device"]["power_limit_w"] = limit
    bad = loaded_forbidden()
    if bad:
        fail(f"loaded after the window: {', '.join(bad)}", 3)
    for name, value, limit, ok in out["lines"]:
        print(f"check {name} {value} limit {limit} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(out["result"]))


if __name__ == "__main__":
    main()
