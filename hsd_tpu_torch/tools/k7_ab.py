"""Time the port's GPTQ kernels for one or more checkouts of the repository
in turns, on one CUDA card:
  * K7 (int8) and K7i4 (packed int4), `csrc/gptq_mma.cu`, at the
    Llama-3.1-8B EAGLE pool forward's shapes (480 rows), and wqkv and wgu
    with the norm at the bf16 route's fewest rows (129), wo with zero
    points, and the host microseconds of one K7 call (wgu + norm, 480
    rows);
  * K4 and K5 (int8, f32-exact operands) at the shapes where the int8 EAGLE
    prefill (60-64 rows), the EAGLE-3 head's beam (80 rows) and the decode
    calls (1 row) launch them;
  * K1 and K3 (packed int4, f32-exact operands) at the speculative main
    path's 14B-geometry shapes: the decode (1 row), the K = 1 verify (11
    rows), the prefill (63 rows) and the K = 11 verify (121 rows), and at
    the int4 EAGLE prefill's Llama-3.1-8B shapes (11 and 64 rows);
  * K2 (the fused 14B layer tail) at 1 and 11 rows and K6 (its MLP) at 11
    rows, and the tail's three products apart as K1 / K3 calls at 11 rows:
    wo on bf16 x, wgu + norm and wdown on f32 x (the tail's f32 x' and ff;
    the calls end in the plain split sum where the tail ends in its
    epilogue pass), with the host microseconds to enqueue one K2 call
    (bursts of 20 calls from an idle queue, the median burst);
  * K8 (flash-decode attention, `csrc/flash_decode.cu`, bf16) at every
    shape of `chip_smoke.ATTN_SHAPES` (the 0.5B draft, the 14B verify, the
    8B EAGLE tree and prefill, 14B long context), raw q and with the fused
    RoPE, with the host microseconds of one call at the draft's T = 1.

    python hsd_tpu_torch/tools/k7_ab.py                  # this checkout
    python hsd_tpu_torch/tools/k7_ab.py --roots A B B A  # checkouts in turns
    python hsd_tpu_torch/tools/k7_ab.py --only '^K7 '    # K7's shapes only
    python hsd_tpu_torch/tools/k7_ab.py --only '^K8'     # K8's shapes only

Each root runs in a process of its own (every checkout defines
`hsd_tpu_torch`), builds its own kernels and prints one JSON line: the
device median ms of one call per shape (cold L2, CUDA events) and a sha256
of each output. K7i4 is timed where the checkout has it. Weights are random
codes with bf16 scales, one group per 128 input rows (the draft's case with
f32 zeros too), and the activations random bf16, all made from --seed (the
same draws, shape by shape, in every checkout); K8's queries, cache and
bias come from a generator of their own, seeded from --seed and the
shape. The registers and spills of each checkout's kernels (`nvcc -Xptxas
-v`) follow,
then the host microseconds by root, the K7 / K7i4 rates (TFLOP/s of 2 n din
dout by root), and the last line is a table of each shape's medians by
root. Imports torch only.
"""
from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

# (label, din, dout, norm, rows): 480 = 8 slots x 60 tree nodes; 129 the
# bf16 route's fewest rows; "zeros": an asymmetric weight (f32 zero points)
MMA_SHAPES = (("wqkv 4096x6144 +norm", 4096, 6144, True, 480),
              ("wgu 4096x28672 +norm", 4096, 28672, True, 480),
              ("wo 4096x4096", 4096, 4096, False, 480),
              ("wdown 14336x4096", 14336, 4096, False, 480),
              ("lm_head 4096x128256", 4096, 128256, False, 480),
              ("wqkv 4096x6144 +norm", 4096, 6144, True, 129),
              ("wgu 4096x28672 +norm", 4096, 28672, True, 129),
              ("wo 4096x4096 zeros", 4096, 4096, False, 480))
# (kernel, label, din, dout, rows, zeros); K1 and K5 take the norm
F32_SHAPES = (("K5", "wgu 4096x28672 +norm", 4096, 28672, 60, False),
              ("K5", "wqkv 4096x6144 +norm", 4096, 6144, 60, False),
              ("K4", "wdown 14336x4096", 14336, 4096, 64, False),
              ("K4", "wo 4096x4096", 4096, 4096, 64, False),
              ("K4", "eagle-3 head wdown 14336x4096", 14336, 4096, 80, False),
              ("K4", "eagle-3 head lm_head 4096x32000", 4096, 32000, 80,
               False),
              ("K4", "lm_head 4096x128256", 4096, 128256, 1, False),
              ("K5", "wqkv 4096x6144 +norm", 4096, 6144, 1, False),
              ("K4", "0.5B draft wgu 896x9728 zeros", 896, 9728, 1, True),
              ("K1", "wgu 4096x28672 +norm", 4096, 28672, 11, False),
              ("K1", "wgu 4096x28672 +norm", 4096, 28672, 64, False),
              ("K3", "wdown 14336x4096", 14336, 4096, 11, False),
              ("K3", "wdown 14336x4096", 14336, 4096, 64, False),
              ("K1", "14B wqkv 5120x7168 +norm", 5120, 7168, 1, False),
              ("K1", "14B wqkv 5120x7168 +norm", 5120, 7168, 11, False),
              ("K1", "14B wqkv 5120x7168 +norm", 5120, 7168, 63, False),
              ("K1", "14B wqkv 5120x7168 +norm", 5120, 7168, 121, False),
              ("K1", "14B wgu 5120x27648 +norm", 5120, 27648, 63, False),
              ("K3", "14B lm_head 5120x151936", 5120, 151936, 1, False),
              ("K3", "14B lm_head 5120x151936", 5120, 151936, 11, False),
              ("K3", "14B wo 5120x5120", 5120, 5120, 63, False),
              ("K3", "14B wdown 13824x5120", 13824, 5120, 63, False),
              ("K3", "14B wo 5120x5120", 5120, 5120, 11, False),
              ("K1", "14B wgu 5120x27648 +norm f32 x", 5120, 27648, 11,
               False),
              ("K3", "14B wdown 13824x5120 f32 x", 13824, 5120, 11, False),
              ("K2", "14B tail 5120/27648/13824", 5120, 27648, 1, False),
              ("K2", "14B tail 5120/27648/13824", 5120, 27648, 11, False),
              ("K6", "14B mlp 5120/27648/13824", 5120, 27648, 11, False))
# (label, H, Hkv, d, T, S, kv_length, start, bias) of K8: chip_smoke.py's
# ATTN_SHAPES (S 204 = the speculative path's cache, 189 = one EAGLE
# request's, long context L + 64 slots at L = 1056, 2080, 4128)
ATTN_SHAPES = (("0.5B draft", 14, 2, 64, 1, 204, 164, 3, None),
               ("0.5B draft", 14, 2, 64, 2, 204, 164, 3, None),
               ("14B verify", 40, 8, 128, 11, 204, 164, 3, None),
               ("8B EAGLE tree", 32, 8, 128, 60, 189, 100, 0, "tree"),
               ("8B EAGLE prefill", 32, 8, 128, 64, 189, 0, 0, "zero"),
               *(("14B long context", 40, 8, 128, T, L + 64, L, 0, None)
                 for L in (1056, 2080, 4128) for T in (1, 11)))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
KERNELS = re.compile(r"mma_kernel|i8_kernel|matvec_kernel|epilogue_kernel"
                     r"|prep_kernel|flash_\w*kernel")


def ptxas_info(root: str) -> dict:
    """{source: {kernel: {registers, spill_stores}}} of the checkout's
    sources (GPTQ and flash-decode)."""
    info = {}
    for src in sorted(glob.glob(os.path.join(root, "hsd_tpu_torch", "csrc",
                                             "*.cu"))):
        with tempfile.TemporaryDirectory() as d:
            out = subprocess.run(
                ["/usr/local/cuda/bin/nvcc", *NVCC_FLAGS, "-cubin", "-Xptxas",
                 "-v", "-o", os.path.join(d, "k.cubin"), src],
                capture_output=True, text=True, check=True)
        rows, fn = {}, None
        for line in (out.stdout + out.stderr).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1) if KERNELS.search(m.group(1)) else None
                continue
            if fn:
                m = re.search(r"(\d+) bytes spill stores", line)
                if m:
                    rows.setdefault(fn, {})["spill_stores"] = int(m.group(1))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    rows.setdefault(fn, {})["registers"] = int(m.group(1))
        info[os.path.basename(src)] = rows
    return info


def k8_inputs(dev, seed: int, i: int, H, Hkv, d, T, S, kv_len, start, bias):
    """chip_smoke.attention_case's draws, from a generator of their own."""
    import torch
    from hsd_tpu_torch.models.transformer import rope_tables

    g = torch.Generator(device=dev).manual_seed(seed * 1000 + i)
    q = (torch.randn((T, H, d), generator=g, device=dev) * 2).to(
        torch.bfloat16)
    k = torch.randn((S, Hkv, d), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((S, Hkv, d), generator=g, device=dev).to(torch.bfloat16)
    qi = kv_len + torch.arange(T, device=dev)
    st = torch.tensor([start], device=dev)
    ab = None
    if bias == "tree":          # node i attends to its ancestor chain
        anc = torch.rand((T, T), generator=g, device=dev) < 0.6
        anc = torch.tril(anc) | torch.eye(T, dtype=torch.bool, device=dev)
        ab = torch.where(anc, 0.0, -1e30)
    elif bias == "zero":
        ab = torch.zeros((T, T), device=dev)
    cos2, sin2 = rope_tables((qi - start)[None], d, 1e6)
    return q, k, v, qi, st, ab, (cos2[0, :, 0], sin2[0, :, 0])


def worker(root: str, seed: int, repeats: int, only: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from hsd_tpu_torch.ops import flash_decode as FD
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

    def weights(din, dout, packed):
        s = (torch.randn((din // 128, dout), generator=gen, device=dev).abs()
             * 1e-2 + 1e-3).to(torch.bfloat16)
        if packed:
            w = torch.empty((din // 2, dout), dtype=torch.uint8, device=dev)
            w.random_(0, 256, generator=gen)
        else:
            w = torch.empty((din, dout), dtype=torch.int8, device=dev)
            w.random_(-127, 128, generator=gen)
        return w, s

    def act(n, din):
        return torch.randn((n, din), generator=gen, device=dev).to(
            torch.bfloat16)

    res = {"root": root, "ms": {}, "sha256": {}, "host_us": {}, "flop": {}}
    keep = re.compile(only)

    def run(key, fn, flop=None):
        if not keep.search(key):
            return False
        res["sha256"][key] = digest(fn())
        res["ms"][key] = timed(fn)
        if flop:
            res["flop"][key] = flop
        return True

    def host_us(fn, calls=20, bursts=15):
        per = []
        for _ in range(bursts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        return statistics.median(per)

    wanted = lambda keys: any(keep.search(key) for key in keys)
    for i, (label, H, Hkv, d, T, S, kv_len, start, bias) in enumerate(
            ATTN_SHAPES):
        keys = [f"K8 {label} {H}/{Hkv}/{d} T={T} S={S}" + r
                for r in ("", " +rope")]
        if not wanted(keys):
            continue
        q, k, v, qi, st, ab, rope = k8_inputs(dev, seed, i, H, Hkv, d, T, S,
                                              kv_len, start, bias)
        for key, rp in zip(keys, (None, rope)):
            call = (lambda rp=rp: FD.flash_decode(q, k, v, qi, st, kv_len, ab,
                                                  rp))
            if run(key, call) and label == "0.5B draft" and T == 1:
                res["host_us"][key] = host_us(call)
        del q, k, v

    for label, din, dout, norm, n in MMA_SHAPES:
        if not wanted([f"K7 {label}, {n} rows", f"K7i4 {label}, {n} rows"]):
            continue
        x = act(n, din)
        ln = (torch.rand((din,), generator=gen, device=dev) + 0.5) if norm else None
        kw = {"ln": ln, "eps": 1e-5} if norm else {}
        w8, s = weights(din, dout, False)
        if "zeros" in label:
            kw = {"zeros": torch.randn((din // 128, dout), generator=gen,
                                       device=dev) * 4}
        w4 = torch.empty((din // 2, dout), dtype=torch.uint8, device=dev)
        w4.random_(0, 256, generator=gen)
        flop = 2 * n * din * dout
        k7 = lambda: G.int8_matmul_bf16(x, w8, s, **kw)
        key = f"K7 {label}, {n} rows"
        if run(key, k7, flop) and n == 480 and "wgu" in label:
            res["host_us"][key] = host_us(k7)
        run(f"K7i4 {label}, {n} rows",
            lambda: G.int4_matmul_bf16(x, w4, s, **kw), flop)
        del w8, w4

    for name, label, din, dout, n, zeros in F32_SHAPES:
        if not wanted([f"{name} {label}, {n} rows"]):
            continue
        x = act(n, din)
        if "f32 x" in label:
            x = x.float()
        ln = torch.rand((din,), generator=gen, device=dev) + 0.5
        w, s = weights(din, dout, name in ("K1", "K2", "K3", "K6"))
        z = (torch.randn((din // 128, dout), generator=gen, device=dev) * 40
             if zeros else None)
        if name in ("K2", "K6"):  # wo [din, din], wgu [din, dout], wdown [dout/2, din]
            wo, so = weights(din, din, True)
            wd, sd = weights(dout // 2, din, True)
            resid = act(n, din)
            if name == "K2":
                call = lambda: G.attn_mlp_int4(x, resid, wo, so, w, s, wd,
                                               sd, ln, 1e-5)
            else:
                call = lambda: G.mlp_int4(x, w, s, wd, sd, ln, 1e-5)
        else:
            call = {"K1": lambda: G.int4_ln_matmul(x, w, s, ln, 1e-5),
                    "K3": lambda: G.int4_matmul(x, w, s),
                    "K4": lambda: G.int8_matmul(x, w, s, z),
                    "K5": lambda: G.int8_ln_matmul(x, w, s, ln, 1e-5)}[name]
        if run(f"{name} {label}, {n} rows", call) and name == "K2" and n == 11:
            res["host_us"][f"K2 {label}, {n} rows"] = host_us(call)
        del w
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs="+",
                    default=[os.path.dirname(os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--only", default="",
                    help="time only the shapes whose key matches this regex")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.seed, args.repeats,
                                args.only)), flush=True)
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
             str(args.repeats), "--only", args.only], capture_output=True,
            text=True)
        if out.returncode:
            sys.exit(f"{root}: exit {out.returncode}\n{out.stderr[-4000:]}")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    for root in dict.fromkeys(os.path.abspath(r) for r in args.roots):
        print(json.dumps({"root": root, "ptxas": ptxas_info(root)}),
              flush=True)
    table, host, rate = {}, {}, {}
    for r in runs:
        for key, ms in r["ms"].items():
            table.setdefault(key, {}).setdefault(r["root"], []).append(ms)
            if key in r["flop"]:
                rate.setdefault(key, {}).setdefault(r["root"], []).append(
                    r["flop"][key] / ms / 1e9)
        for key, us in r.get("host_us", {}).items():
            host.setdefault(key, {}).setdefault(r["root"], []).append(us)
    print(json.dumps({"host_us_by_root": host}), flush=True)
    print(json.dumps({"tflops_by_root": rate}), flush=True)
    print(json.dumps({"medians_ms_by_root": table}), flush=True)


if __name__ == "__main__":
    main()
