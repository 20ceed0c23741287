#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--trace]

Phases (any failure exits nonzero, with no result line):
  1. card      the card's name and power limit (nvidia-smi)
  2. build     hsd_tpu_torch/csrc/*.cu compiled for sm_90a at first use
  3. weights   the coupled pair of the speculative-decoding benchmark built
               on the card from a seed: a 48-layer 14B-geometry packed-int4
               target (int8 embedding, int4 head) summed with the bf16 0.5B
               trunk, and the asymmetric-int8 0.5B draft (logit_scale 1.467,
               lam 0)
  4. kernels   K1-K4 at the main path's shapes against their plain PyTorch
               versions (max error within 2^-7 of the output's max
               magnitude: two bf16 roundings), timed with CUDA events over
               distinct layers so the weights stream from device memory,
               beside the plain version, one bf16 torch.matmul against the
               pre-dequantized weight, and the bound: the larger of bytes
               over 3.35 TB/s and operations over the 989 TFLOP/s bf16
               tensor-core rate
  5. main path make_generate with hsd and tokenwise (gamma 10, K 1) on 3
               prompts of bucket 64, 128 new tokens each, with the launch
               counters zeroed before and read after; AR over 32 tokens.
               With --trace, also a profiled 24-token hsd generate (device
               time by kernel, idle share) and the host cost of one call
  6. greedy    temperature 0 on a 2-layer float32 pair built through the same
               kernels: the speculative stream must equal the AR stream; at
               full width only the common prefix length is printed
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.
"""
import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    sys.exit(1)

from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine import make_autoregressive, make_generate
from hsd_tpu_torch.eval.synthetic import (build_coupled_pair,
                                          init_quantized_params,
                                          make_coupled_target, quantize_draft)
from hsd_tpu_torch.models.transformer import fuse_params, init_params
from hsd_tpu_torch.ops import _build
from hsd_tpu_torch.ops import gptq_cuda as G
from hsd_tpu_torch.ops.linear import QuantizedLinear

DEV = torch.device("cuda")
HBM_BYTES_S = 3.35e12       # H100 SXM device memory rate
# H100 SXM dense bf16 tensor-core rate: the operands are bf16 activations
# and int4/int8 codes, which the tensor cores take at this rate
BF16_FLOP_S = 989e12
TOL = 2.0 ** -7             # kernel vs plain, relative to the output's max
GAMMA, MAX_NEW, N_PROMPTS, BUCKET, AR_NEW = 10, 128, 3, 64, 32
LOGIT_SCALE = 1.467
SPIN_CYCLES = 2_000_000      # ~1 ms of device spin before a timed call
T0 = time.time()


def log(msg):
    print(f"[{time.time() - T0:6.1f}s] {msg}", flush=True)


_FLUSH = None


def timed(fn, n_sets, repeats=12):
    """Median device milliseconds of one call fn(l), l cycling over n_sets
    distinct weight sets, with the 50 MB L2 flushed before each call so the
    weights stream from device memory as they do on the main path."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(96 * 2**20, dtype=torch.uint8, device=DEV)
    fn(0)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    out = []
    for r in range(repeats):
        _FLUSH.zero_()
        # keep the device busy while the host enqueues the call, so the
        # window holds device time only, not the wrapper's host overhead
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn(r % n_sets)
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return statistics.median(out)


def bound(bytes_moved, flops):
    t_b, t_f = bytes_moved / HBM_BYTES_S, flops / BF16_FLOP_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def qbytes(w: QuantizedLinear):
    return sum(t.numel() * t.element_size()
               for t in (w.qweight, w.scales, w.zeros) if t is not None)


def deq_bf16(w: QuantizedLinear):
    if w.packed_int4:
        return G.dequantize_int4(w.qweight, w.scales, w.zeros).to(torch.bfloat16)
    return G.dequantize_int8(w.qweight, w.scales, w.zeros).to(torch.bfloat16)


KERNEL_ROWS = []      # one dict per (kernel, shape)


def check_kernel(name, label, n, run, plain, library, n_sets, nbytes, flops):
    """run(l) / plain(l) compute layer l's call; library(l) is the one-call
    PyTorch yardstick (or None)."""
    got, want = run(0), plain(0)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = math.isfinite(err) and err <= TOL * scale
    ms = timed(run, n_sets)
    plain_ms = timed(plain, 1, repeats=3)
    lib_ms = timed(library, 1) if library is not None else None
    b_ms, b_by = bound(nbytes, flops)
    row = dict(name=name, label=label, n=n, max_abs_err=err,
               rel_err=err / scale if scale else err, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by)
    KERNEL_ROWS.append(row)
    lib_s = f"{lib_ms:.4f}" if lib_ms is not None else "n/a"
    log(f"{name} {label:<28} n={n:<3} err={err:.3e} "
        f"(rel {row['rel_err']:.2e}, tol {TOL:.2e}) kernel={ms:.4f}ms "
        f"plain={plain_ms:.4f}ms library={lib_s}ms "
        f"bound={b_ms:.4f}ms ({b_by})")
    if not ok:
        raise AssertionError(f"{name} {label} n={n}: error {err} > "
                             f"{TOL} x {scale}")


def kernel_phase(draft, target, cfg_b):
    g = torch.Generator(device=DEV).manual_seed(123)
    big = target.big.layers
    D = cfg_b.hidden_size
    eps = cfg_b.rms_norm_eps
    # norm weights away from 1 so the fused norm's weight is exercised
    ln = torch.rand((4, D), generator=g, device=DEV) + 0.5

    def act(n, d):
        return torch.randn((n, d), generator=g, device=DEV).to(torch.bfloat16)

    def linear_case(name, label, w: QuantizedLinear, n):
        stacked = w.qweight.dim() == 3
        n_sets = min(4, w.qweight.shape[0]) if stacked else 1
        ws = [w.layer(l) if stacked else w for l in range(n_sets)]
        x = act(n, w.din)
        dout = w.qweight.shape[-1]
        if name == "K1":
            def run(l):
                return G.int4_ln_matmul(x, ws[l].qweight, ws[l].scales,
                                        ln[l], eps)

            def plain(l):
                return G.int4_ln_matmul_plain(x, ws[l].qweight,
                                              ws[l].scales, ln[l], eps)
        elif name == "K3":
            def run(l):
                return G.int4_matmul(x, ws[l].qweight, ws[l].scales)

            def plain(l):
                return G.int4_matmul_plain(x, ws[l].qweight, ws[l].scales)
        else:
            def run(l):
                return G.int8_matmul(x, ws[l].qweight, ws[l].scales,
                                     ws[l].zeros)

            def plain(l):
                return G.int8_matmul_plain(x, ws[l].qweight, ws[l].scales,
                                           ws[l].zeros)
        w_bf16 = deq_bf16(ws[0])
        check_kernel(name, label, n, run, plain,
                     lambda l: torch.matmul(x, w_bf16), n_sets,
                     qbytes(ws[0]) + x.numel() * 2 + n * dout * 2,
                     2 * n * w.din * dout)
        del w_bf16

    # a row's bits do not depend on how many rows share its launch
    x = act(63, D)
    w, dw = big["wqkv"].layer(0), draft.layers["wgu"].layer(0)
    xd = act(62, dw.din)
    for n in (1, 2, 11):
        same = (torch.equal(G.int4_ln_matmul(x[:n], w.qweight, w.scales,
                                             ln[0], eps),
                            G.int4_ln_matmul(x, w.qweight, w.scales, ln[0],
                                             eps)[:n])
                and torch.equal(G.int8_matmul(xd[:n], dw.qweight, dw.scales,
                                              dw.zeros),
                                G.int8_matmul(xd, dw.qweight, dw.scales,
                                              dw.zeros)[:n]))
        if not same:
            raise AssertionError(f"rows differ between {n} and 63 rows")
    log("kernels: K1 and K4 give the same bits for a row at 1, 2, 11 and "
        "62/63 rows")

    log("kernels: K1 (int4, fused RMSNorm)")
    for n in (1, 11, 63, 7):
        linear_case("K1", "target wqkv 5120x7168", big["wqkv"], n)
    linear_case("K1", "target wgu 5120x27648", big["wgu"], 63)

    log("kernels: K3 (int4)")
    for n in (1, 11):
        linear_case("K3", "target lm_head 5120x151936", target.big.lm_head, n)
    linear_case("K3", "target wo 5120x5120", big["wo"], 63)
    linear_case("K3", "target wdown 13824x5120", big["wdown"], 63)
    ragged = QuantizedLinear(big["wo"].qweight[0, :, :1000].contiguous(),
                             big["wo"].scales[0, :, :1000].contiguous(), None)
    linear_case("K3", "ragged 5120x1000", ragged, 7)

    log("kernels: K4 (int8, zero points)")
    for nm in ("wqkv", "wo", "wgu", "wdown"):
        w = draft.layers[nm]
        for n in (1, 2, 62):
            linear_case("K4", f"draft {nm} {w.din}x{w.qweight.shape[-1]}",
                        w, n)

    log("kernels: K2 (fused int4 layer tail)")
    wo, wgu, wdown, ln2 = big["wo"], big["wgu"], big["wdown"], ln
    tail_bytes = sum(qbytes(w.layer(0)) for w in (wo, wgu, wdown))
    F2 = wgu.qweight.shape[-1]
    # yardstick, not one call: the tail's three products as bf16 matmuls
    # against pre-dequantized weights, with the SwiGLU and both residuals
    # but no norm (JSON library_ms stays null for K2)
    w3 = [deq_bf16(w.layer(0)) for w in (wo, wgu, wdown)]

    def three_matmuls(att, res):
        xp = res + torch.matmul(att, w3[0])
        gu = torch.matmul(xp, w3[1])
        ff = torch.nn.functional.silu(gu[:, :F2 // 2]) * gu[:, F2 // 2:]
        return xp + torch.matmul(ff, w3[2])

    for n in (1, 11, 7):
        att, res = act(n, D), act(n, D)

        def run(l):
            return G.attn_mlp_int4(att, res, wo.qweight[l], wo.scales[l],
                                   wgu.qweight[l], wgu.scales[l],
                                   wdown.qweight[l], wdown.scales[l], ln2[l],
                                   eps)

        def plain(l):
            return G.attn_mlp_int4_plain(att, res, wo.qweight[l],
                                         wo.scales[l], wgu.qweight[l],
                                         wgu.scales[l], wdown.qweight[l],
                                         wdown.scales[l], ln2[l], eps)
        check_kernel("K2", "target tail 5120/27648/13824", n, run, plain,
                     lambda l: three_matmuls(att, res), 4,
                     tail_bytes + 3 * n * D * 2,
                     2 * n * (D * D + D * F2 + F2 // 2 * D))


def summary_entry(name, label, n, source, replaces, launches):
    rows = [r for r in KERNEL_ROWS if r["name"] == name]
    rep = next(r for r in rows if r["label"] == label and r["n"] == n)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"] if name != "K2" else None,
            "shape": f"{label}, {n} rows"}


def trace_window(gen, draft, target, prompt):
    """Where the time goes: one short hsd generate under torch.profiler.
    Device time by kernel, the wall time, and the device's idle share
    (1 - device busy / wall; one stream, so kernels do not overlap). The
    profiler's own host cost lengthens the wall, so the idle share is an
    upper bound."""
    from torch.profiler import ProfilerActivity, profile
    # device activity only: CPU-op aggregates would count kernels twice
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = gen(draft, target, prompt, BUCKET,
                  torch.Generator(device=DEV).manual_seed(9))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    ours = sum(r[0] for r in rows if "gptq_matvec" in r[2]
               or "splitk_reduce" in r[2] or "inv_rms" in r[2])
    out = dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
               idle_share=1 - busy / wall_us, gptq_kernels_ms=ours / 1e3,
               blocks=res.blocks, tokens=res.ncommit,
               launches=sum(r[1] for r in rows))
    log(f"trace (hsd, {res.ncommit} tokens, {res.blocks} blocks, under the "
        f"profiler): wall {out['wall_ms']:.1f} ms, device busy "
        f"{out['device_busy_ms']:.1f} ms (GPTQ kernels "
        f"{out['gptq_kernels_ms']:.1f} ms), idle share "
        f"{out['idle_share']:.3f}, {out['launches']} device ops")
    for dev_us, count, key in rows[:10]:
        log(f"  {dev_us / 1e3:9.3f} ms  x{count:<6} {key[:90]}")
    return out


def host_cost(draft):
    """Host microseconds to enqueue one K4 wrapper call at the draft step's
    shape, and one small PyTorch op, with the device left to run behind."""
    w = draft.layers["wqkv"].layer(0)
    x = torch.randn((1, w.din), device=DEV).to(torch.bfloat16)
    out = {}
    for name, fn in (("k4_wrapper_us",
                      lambda: G.int8_matmul(x, w.qweight, w.scales, w.zeros)),
                     ("torch_add_us", lambda: torch.add(x, x))):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn()
        out[name] = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
    log(f"host cost per call: K4 wrapper {out['k4_wrapper_us']:.1f} us, "
        f"torch.add {out['torch_add_us']:.1f} us")
    return out


def main_path(draft, target, cfg_s, cfg_b, trace):
    fwd, ops = make_coupled_target(cfg_s, cfg_b)
    prompts = [((torch.arange(BUCKET, device=DEV) + 97 * i) % 1000) + 10
               for i in range(N_PROMPTS)]

    def gen_for(method, max_new=MAX_NEW, temperature=1.0):
        eng = EngineConfig(verifier=VerifierConfig(method=method, gamma=GAMMA,
                                                   num_drafts=1),
                           max_new_tokens=max_new, temperature=temperature)
        return make_generate(cfg_s, cfg_b, eng, target_forward=fwd,
                             target_cache_ops=ops)

    # warm the path (allocator, cuBLAS handles) outside the counted run
    gen_for("hsd", max_new=12)(draft, target, prompts[0], BUCKET,
                               torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    G.reset_launches()
    results = {}
    for mi, method in enumerate(("hsd", "tokenwise")):
        gen = gen_for(method)
        per_prompt, toks, secs = [], 0, 0.0
        for i, prompt in enumerate(prompts):
            gch = torch.Generator(device=DEV).manual_seed(100 * mi + i)
            t0 = time.perf_counter()
            res = gen(draft, target, prompt, BUCKET, gch)
            torch.cuda.synchronize()
            secs += time.perf_counter() - t0
            toks += res.ncommit
            acc = res.accepts[:res.blocks].float()
            per_prompt.append(float((acc + 1).mean()))
            out = res.tokens[BUCKET:res.length]
            if not (0 <= int(out.min()) and int(out.max()) < cfg_b.vocab_size):
                raise AssertionError(f"{method}: token out of range")
            if res.ncommit < 1:
                raise AssertionError(f"{method}: nothing committed")
        be = statistics.mean(per_prompt)
        results[method] = dict(be=be, tok_s=toks / secs, tokens=toks,
                               secs=secs, per_prompt=per_prompt)
        log(f"main path {method}: BE {be:.4f} (per prompt {per_prompt}) "
            f"{toks / secs:.2f} tok/s ({toks} tokens in {secs:.2f}s)")
    counts = G.launch_counts()
    log(f"launch counters over the hsd+tokenwise runs: {counts}")
    for k, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")

    ar = make_autoregressive(cfg_b, EngineConfig(max_new_tokens=AR_NEW),
                             model_forward=fwd, cache_init=ops[0])
    ar(target, prompts[0], BUCKET, torch.Generator(device=DEV).manual_seed(7))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, length = ar(target, prompts[0], BUCKET,
                   torch.Generator(device=DEV).manual_seed(8))
    torch.cuda.synchronize()
    ar_s = time.perf_counter() - t0
    results["ar_tok_s"] = (length - BUCKET) / ar_s
    log(f"AR: {length - BUCKET} tokens in {ar_s:.3f}s = "
        f"{results['ar_tok_s']:.2f} tok/s")
    if trace:
        trace_window(gen_for("hsd", max_new=24), draft, target, prompts[1])
        host_cost(draft)

    # full-width greedy: report only the common prefix of spec and AR
    eng0 = EngineConfig(verifier=VerifierConfig(method="greedy", gamma=GAMMA),
                        max_new_tokens=32, temperature=0.0)
    res = make_generate(cfg_s, cfg_b, eng0, target_forward=fwd,
                        target_cache_ops=ops)(draft, target, prompts[0],
                                              BUCKET, None)
    ar_toks, ar_len = make_autoregressive(
        cfg_b, eng0, model_forward=fwd, cache_init=ops[0])(
            target, prompts[0], BUCKET, None)
    a = res.tokens[BUCKET:res.length].tolist()
    b = ar_toks[BUCKET:ar_len].tolist()
    common = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                  min(len(a), len(b)))
    log(f"full-width greedy: spec and AR agree on the first {common} of "
        f"{min(len(a), len(b))} tokens")
    results["greedy_common_prefix"] = common
    return results, counts


def greedy_small():
    """2-layer float32 pair through the same kernels: spec == AR, asserted."""
    cfg_s = ModelConfig.tiny(vocab_size=512, hidden_size=256,
                             intermediate_size=512, num_heads=4,
                             num_kv_heads=2, dtype=torch.float32,
                             eos_token_id=10**9)
    small = fuse_params(cfg_s, init_params(cfg_s, seed=5, device=DEV))
    draft = quantize_draft(cfg_s, small, bits=8)
    target = init_quantized_params(cfg_s, seed=6, bits=4, device=DEV)
    eng = EngineConfig(verifier=VerifierConfig(method="greedy", gamma=4),
                       max_new_tokens=48, temperature=0.0)
    prompt = (torch.arange(16, device=DEV) % 300) + 3
    before = G.launch_counts()
    res = make_generate(cfg_s, cfg_s, eng)(draft, target, prompt, 12, None)
    toks, length = make_autoregressive(cfg_s, eng)(target, prompt, 12, None)
    used = {k: v - before[k] for k, v in G.launch_counts().items()}
    n = min(res.length, length)
    a, b = res.tokens[16:n].tolist(), toks[16:n].tolist()
    log(f"greedy 2-layer f32: {len(a)} tokens, spec == AR: {a == b}; "
        f"kernel launches {used}")
    if a != b or len(a) < 48:
        raise AssertionError(f"greedy spec != greedy AR:\n{a}\n{b}")
    if min(used.values()) <= 0:
        raise AssertionError(f"greedy config missed a kernel: {used}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", action="store_true",
                    help="also profile a short hsd generate (device time by "
                         "kernel, idle share) and time the host cost per call")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.time()
    _build.lib("gptq")
    log(f"kernels built and loaded in {time.time() - t0:.1f}s")

    cfg_s = ModelConfig.qwen2_05b()
    cfg_b = ModelConfig.qwen2_14b()
    t0 = time.time()
    draft, target = build_coupled_pair(0, cfg_s, cfg_b, lam=0.0,
                                       logit_scale=LOGIT_SCALE, device=DEV)
    torch.cuda.synchronize()
    log(f"coupled pair built in {time.time() - t0:.1f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    kernel_phase(draft, target, cfg_b)
    results, counts = main_path(draft, target, cfg_s, cfg_b, args.trace)
    greedy_small()

    src = "hsd_tpu_torch/csrc/gptq.cu"
    kernels = [
        summary_entry("K1", "target wqkv 5120x7168", 11, src,
                      "hsd_tpu/ops/gptq_pallas.py:176", counts["K1"]),
        summary_entry("K2", "target tail 5120/27648/13824", 11, src,
                      "hsd_tpu/ops/gptq_pallas.py:617", counts["K2"]),
        summary_entry("K3", "target lm_head 5120x151936", 11, src,
                      "hsd_tpu/ops/gptq_pallas.py:117", counts["K3"]),
        summary_entry("K4", "draft wgu 896x9728", 1, src,
                      "hsd_tpu/ops/gptq_pallas.py:44", counts["K4"]),
    ]
    log(f"main path: hsd BE {results['hsd']['be']:.4f} "
        f"{results['hsd']['tok_s']:.2f} tok/s, tokenwise BE "
        f"{results['tokenwise']['be']:.4f} "
        f"{results['tokenwise']['tok_s']:.2f} tok/s, AR "
        f"{results['ar_tok_s']:.2f} tok/s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
