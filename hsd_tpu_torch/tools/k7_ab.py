"""Time the port's tensor-core kernels K7 (int8) and K7i4 (packed int4),
`hsd_tpu_torch/csrc/gptq_mma.cu`, at the Llama-3.1-8B EAGLE pool forward's
shapes (480 rows), for one or more checkouts of the repository in turns, on
one CUDA card.

    python hsd_tpu_torch/tools/k7_ab.py                  # this checkout
    python hsd_tpu_torch/tools/k7_ab.py --roots A B B A  # checkouts in turns

Each root runs in a process of its own (every checkout defines
`hsd_tpu_torch`), builds its own kernels and prints one JSON line: the
device median ms of one call per shape (cold L2, CUDA events), a sha256 of
each output, and the MMA kernels' registers and spills from
`nvcc -Xptxas -v`. K7i4 is timed where the checkout has it. Weights are
random codes with bf16 scales, one group per 128 input rows, and the
activations random bf16, all made from --seed. The last line is a table of
each shape's medians by root. Imports torch only.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROWS = 480                                 # 8 slots x 60 tree nodes
SHAPES = (("wqkv 4096x6144 +norm", 4096, 6144, True),
          ("wgu 4096x28672 +norm", 4096, 28672, True),
          ("wo 4096x4096", 4096, 4096, False),
          ("wdown 14336x4096", 14336, 4096, False),
          ("lm_head 4096x128256", 4096, 128256, False))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")


def ptxas_info(root: str) -> dict:
    """{kernel: 'N registers, S bytes spill stores'} of gptq_mma.cu."""
    src = os.path.join(root, "hsd_tpu_torch", "csrc", "gptq_mma.cu")
    with tempfile.TemporaryDirectory() as d:
        out = subprocess.run(
            ["/usr/local/cuda/bin/nvcc", *NVCC_FLAGS, "-cubin", "-Xptxas", "-v",
             "-o", os.path.join(d, "k.cubin"), src],
            capture_output=True, text=True, check=True)
    info, fn = {}, None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            continue
        if fn and "mma_kernel" in fn:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                info.setdefault(fn, {})["spill_stores"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                info.setdefault(fn, {})["registers"] = int(m.group(1))
    return info


def worker(root: str, seed: int, repeats: int) -> dict:
    sys.path.insert(0, root)
    import torch
    from hsd_tpu_torch.ops import gptq_cuda as G

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)

    def timed(fn):
        fn()
        out = []
        for _ in range(repeats):
            flush.zero_()
            torch.cuda._sleep(2_000_000)       # the window holds device time
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            out.append(e0.elapsed_time(e1))
        return statistics.median(out)

    def digest(t):
        return hashlib.sha256(t.view(torch.int16).cpu().numpy()
                              .tobytes()).hexdigest()[:16]

    res = {"root": root, "ptxas": ptxas_info(root), "ms": {}, "sha256": {}}
    for label, din, dout, norm in SHAPES:
        x = torch.randn((ROWS, din), generator=gen, device=dev).to(torch.bfloat16)
        ln = (torch.rand((din,), generator=gen, device=dev) + 0.5) if norm else None
        kw = {"ln": ln, "eps": 1e-5} if norm else {}
        s = (torch.randn((din // 128, dout), generator=gen, device=dev).abs()
             * 1e-2 + 1e-3).to(torch.bfloat16)
        w8 = torch.empty((din, dout), dtype=torch.int8, device=dev)
        w8.random_(-127, 128, generator=gen)
        w4 = torch.empty((din // 2, dout), dtype=torch.uint8, device=dev)
        w4.random_(0, 256, generator=gen)
        cases = {"K7": lambda: G.int8_matmul_bf16(x, w8, s, **kw)}
        if hasattr(G, "int4_matmul_bf16"):
            cases["K7i4"] = lambda: G.int4_matmul_bf16(x, w4, s, **kw)
        for name, fn in cases.items():
            key = f"{name} {label}"
            res["sha256"][key] = digest(fn())
            res["ms"][key] = timed(fn)
        del w8, w4
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs="+",
                    default=[os.path.dirname(os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.seed, args.repeats)),
              flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = []
    for root in args.roots:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             os.path.abspath(root), "--seed", str(args.seed), "--repeats",
             str(args.repeats)], capture_output=True, text=True)
        if out.returncode:
            sys.exit(f"{root}: exit {out.returncode}\n{out.stderr[-4000:]}")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    table = {}
    for r in runs:
        for key, ms in r["ms"].items():
            table.setdefault(key, {}).setdefault(r["root"], []).append(ms)
    print(json.dumps({"medians_ms_by_root": table}), flush=True)


if __name__ == "__main__":
    main()
