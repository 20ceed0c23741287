"""The reference's main-path cell (`bench.py:59-138` and `:478-529`) on the
port, on one CUDA card: the asymmetric-int8 0.5B draft speculating for the
48-layer packed-int4 14B target coupled to the bf16 0.5B trunk
(`build_coupled_pair(0, qwen2_05b(), qwen2_14b(), lam=0.0,
logit_scale=S)`), gamma 10, 256 new tokens, temperature 1.0, the one
64-token prompt `(arange(64) % 1000) + 10`.

    python hsd_tpu_torch/tools/bench_main.py --scale 1.467 --rows k1,ar
    python hsd_tpu_torch/tools/bench_main.py --calibrate --rows k1
    python hsd_tpu_torch/tools/bench_main.py --scale 1.467 --rows k11

Rows (`--rows`, comma-separated):
  k1   hsd and tokenwise at K = 1;
  k11  hsd and tokenwise at K = 11, parallel multidraft (a 693-row target
       prefill and a 682-row draft prefill on the dequantize route, a
       121-row verify, an 11-row draft); before them the two prefills are
       timed apart with their peak allocation;
  ar   autoregressive sampling over 96 tokens on the coupled target.
Each speculative row makes one warm run, then 10 timed runs, one per
seed, each from the call to `torch.cuda.synchronize()`. BE per run is
mean(accepts + 1) over its blocks; the row's BE is the mean over runs,
CI95 = 1.96 * sd(ddof=1) / sqrt(n); tok/s is the committed tokens over
the timed seconds.

`--scale S` fixes the trunk sharpening; `--calibrate` finds it as
`calibrate_scale` does (`bench.py:96-138`): bisection from [1.0, 1.65]
toward tokenwise BE 5.99 at K = 1, 6 runs a probe, each probe on a pair
built anew (one pair on the card at a time), and prints its probe log.

Generators: `bench.py` folds its key with 1 (hsd), 2 (tokenwise, and the
calibration's probes) and 3 (both K = 11 rows), then with 100 + i for run
i and 999 for the warm run. Here fold f and offset o give
`torch.Generator(device="cuda").manual_seed(1000 * f + o)`.

Prints progress lines, the card's name and power limit (nvidia-smi) and,
as its last line, one JSON object: each row's BE, CI95, tok/s, tokens,
seconds, per-run BEs and launch counts (`hsd_tpu_torch.ops.launch_counts`
over its timed runs), each BE against the reference's band
(`BENCH_r05.json`), the scale and the probe log. Imports torch only.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import torch

if __package__ in (None, ""):            # run as a script from its path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine import make_autoregressive, make_generate
from hsd_tpu_torch.engine.kvcache import init_cache
from hsd_tpu_torch.eval.synthetic import build_coupled_pair, make_coupled_target
from hsd_tpu_torch.models import transformer
from hsd_tpu_torch.ops import _build, launch_counts, reset_launches
from hsd_tpu_torch.ops import flash_decode as FD

GAMMA, MAX_NEW, N_RUNS, AR_NEW = 10, 256, 10, 96
BUCKET = 64
K11 = 11
TARGET_BE = 5.99            # tokenwise BE the calibration aims at
SCALE_RANGE = (1.0, 1.65)   # bench.py's bisection bracket
PROBE_RUNS = 6
FOLD = {"hsd": 1, "tokenwise": 2, "k11": 3}
WARM, RUN0 = 999, 100
# the reference's BE +- CI95 per row (BENCH_r05.json)
BANDS = {"hsd_k1": (7.517, 0.52), "tokenwise_k1": (6.149, 0.405),
         "hsd_k11": (7.787, 0.353), "tokenwise_k11": (6.705, 0.289)}
T0 = time.time()


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def prompt_for(device) -> torch.Tensor:
    return (torch.arange(BUCKET, device=device) % 1000) + 10


def seed_of(fold: int, offset: int) -> int:
    return 1000 * fold + offset


def row_stats(accepts: List[List[int]], tokens: int, seconds: float) -> dict:
    """bench.run's statistics: BE per run = mean(accepts + 1); the row's
    BE is their mean, CI95 = 1.96 * sd(ddof=1) / sqrt(n)."""
    per_run = [statistics.fmean(a + 1 for a in acc) for acc in accepts if acc]
    be = statistics.fmean(per_run) if per_run else 0.0
    ci = (1.96 * statistics.stdev(per_run) / math.sqrt(len(per_run))
          if len(per_run) > 1 else 0.0)
    return dict(be=be, ci95=ci, tok_s=tokens / seconds if seconds else 0.0,
                tokens=tokens, seconds=seconds, per_run=per_run)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_row(gen: Callable, draft, target, fold: int, n_runs: int,
            device, vocab: int, warm: bool = True) -> dict:
    """One warm run (seed offset 999), then n_runs timed runs (100 + i);
    the launch counters cover the timed runs only."""
    prompt = prompt_for(device)

    def generator(offset):
        return torch.Generator(device=device).manual_seed(
            seed_of(fold, offset))

    if warm:
        gen(draft, target, prompt, BUCKET, generator(WARM))
        sync(device)
    reset_launches()
    accepts, tokens, seconds = [], 0, 0.0
    for i in range(n_runs):
        g = generator(RUN0 + i)
        t0 = time.perf_counter()
        res = gen(draft, target, prompt, BUCKET, g)
        sync(device)
        seconds += time.perf_counter() - t0
        tokens += res.ncommit
        accepts.append(res.accepts[:res.blocks].tolist())
        out = res.tokens[BUCKET:res.length]
        if res.ncommit < 1 or int(out.min()) < 0 or \
                int(out.max()) >= vocab:
            raise AssertionError("a run committed nothing or out of range")
    out = row_stats(accepts, tokens, seconds)
    out["launches"] = launch_counts()
    return out


def spec_gen(cfg_s: ModelConfig, cfg_b: ModelConfig, method: str, K: int,
             fwd, ops, max_new: int = MAX_NEW):
    eng = EngineConfig(verifier=VerifierConfig(method=method, gamma=GAMMA,
                                               num_drafts=K),
                       max_new_tokens=max_new, temperature=1.0)
    return make_generate(cfg_s, cfg_b, eng, target_forward=fwd,
                         target_cache_ops=ops)


def calibrate_scale(be_at: Callable[[float], float],
                    target_be: float = TARGET_BE, probes: int = 4,
                    bracket: Tuple[float, float] = SCALE_RANGE):
    """`bench.calibrate_scale`'s search: the scale whose tokenwise BE is
    within 0.15 (first probe) or 0.1 (bisection) of target_be, raising
    the upper end by 1.4x while the BE there is still above the target (BE
    falls as the scale rises). Returns (scale, [(scale, be), ...])."""
    probe_log: List[Tuple[float, float]] = []

    def probe(s):
        be = be_at(s)
        probe_log.append((s, be))
        return be

    lo, hi = bracket
    be_hi = probe(hi)
    if abs(be_hi - target_be) < 0.15:
        return hi, probe_log
    while be_hi > target_be and hi < 4.0:
        lo, hi = hi, hi * 1.4
        be_hi = probe(hi)
    for _ in range(probes):
        mid = 0.5 * (lo + hi)
        if probe(mid) < target_be:
            hi = mid
        else:
            lo = mid
        if abs(probe_log[-1][1] - target_be) < 0.1:
            return probe_log[-1][0], probe_log
    return 0.5 * (lo + hi), probe_log


def build_pair(cfg_s, cfg_b, scale: float, device):
    t0 = time.time()
    draft, target = build_coupled_pair(0, cfg_s, cfg_b, lam=0.0,
                                       logit_scale=scale, device=device)
    sync(device)
    return draft, target, time.time() - t0


def free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def prefill_cost(cfg_s, cfg_b, draft, target, fwd, ops, K: int, device):
    """The K-row prefills of make_generate, timed apart: the target over
    K x (bucket - 1) rows and the draft over K x (bucket - 2), each with
    the launch counts and the peak allocation above what was allocated
    before it. Each runs once untimed first."""
    P = BUCKET
    S = P + MAX_NEW + GAMMA + 2
    start = torch.zeros((K,), dtype=torch.int64, device=device)
    pk = prompt_for(device)[None, :].expand(K, P)
    calls = {
        "target": lambda: fwd(target, pk[:, :-1],
                              ops[0](K, S, start.clone(), device),
                              skip_head=True),
        "draft": lambda: transformer.forward(
            cfg_s, draft, pk[:, :-2],
            init_cache(cfg_s, K, S, device).replace(start=start.clone()),
            skip_head=True)}
    out = {}
    cuda = torch.device(device).type == "cuda"
    for name, call in calls.items():
        call()
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        call()
        sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        peak = ((torch.cuda.max_memory_allocated() - base) / 2 ** 30
                if cuda else None)
        rows = K * (P - 1 if name == "target" else P - 2)
        launched = {k: v for k, v in launch_counts().items() if v}
        out[name] = dict(rows=rows, ms=ms, peak_gib=peak, launches=launched)
        log(f"K = {K} {name} prefill ({rows} rows): {ms:.2f} ms, peak "
            f"{'not measured' if peak is None else f'{peak:.3f} GiB'} above "
            f"the allocated, kernel launches {launched or 'none'}")
    return out


def against_band(name: str, row: dict) -> Optional[dict]:
    """Where the row's BE lies against the reference's BE +- CI95."""
    if name not in BANDS:
        return None
    ref, ci = BANDS[name]
    lo, hi = ref - ci, ref + ci
    be = row["be"]
    outside = lo - be if be < lo else (be - hi if be > hi else 0.0)
    return dict(reference=ref, ci95=ci, low=lo, high=hi,
                inside=outside == 0.0, outside_by=outside)


def measure(rows: List[str], scale: float, cfg_s: ModelConfig,
            cfg_b: ModelConfig, device, n_runs: int = N_RUNS,
            ar_new: int = AR_NEW) -> dict:
    """Build the pair at `scale` and run the rows. Returns {"build_s",
    "rows": {row name: stats}} and, with k11, "prefill_k11"."""
    fwd, ops = make_coupled_target(cfg_s, cfg_b)
    draft, target, build_s = build_pair(cfg_s, cfg_b, scale, device)
    log(f"pair at scale {scale} built in {build_s:.1f}s")
    out = {"build_s": build_s, "rows": {}}
    V = cfg_b.vocab_size
    if "k1" in rows:
        for method in ("hsd", "tokenwise"):
            r = run_row(spec_gen(cfg_s, cfg_b, method, 1, fwd, ops), draft,
                        target, FOLD[method], n_runs, device, V)
            out["rows"][f"{method}_k1"] = r
            log(f"{method} K = 1: BE {r['be']} +- {r['ci95']} "
                f"{r['tok_s']} tok/s ({r['tokens']} tokens in "
                f"{r['seconds']}s) per run {r['per_run']} launches "
                f"{r['launches']}")
    if "k11" in rows:
        out["prefill_k11"] = prefill_cost(cfg_s, cfg_b, draft, target, fwd,
                                          ops, K11, device)
        for method in ("hsd", "tokenwise"):
            r = run_row(spec_gen(cfg_s, cfg_b, method, K11, fwd, ops),
                        draft, target, FOLD["k11"], n_runs, device, V)
            out["rows"][f"{method}_k11"] = r
            log(f"{method} K = 11: BE {r['be']} +- {r['ci95']} "
                f"{r['tok_s']} tok/s ({r['tokens']} tokens in "
                f"{r['seconds']}s) per run {r['per_run']} launches "
                f"{r['launches']}")
    if "ar" in rows:
        ar = make_autoregressive(
            cfg_b, EngineConfig(max_new_tokens=ar_new, temperature=1.0),
            model_forward=fwd, cache_init=ops[0])
        prompt = prompt_for(device)
        ar(target, prompt, BUCKET, torch.Generator(device=device)
           .manual_seed(7))
        sync(device)
        reset_launches()
        t0 = time.perf_counter()
        _, length = ar(target, prompt, BUCKET,
                       torch.Generator(device=device).manual_seed(8))
        sync(device)
        secs = time.perf_counter() - t0
        out["rows"]["ar"] = dict(tok_s=(length - BUCKET) / secs,
                                 tokens=length - BUCKET, seconds=secs,
                                 launches=launch_counts())
        log(f"AR: {length - BUCKET} tokens in {secs}s = "
            f"{out['rows']['ar']['tok_s']} tok/s")
    del draft, target
    free(device)
    return out


def calibrate(cfg_s, cfg_b, device, n_runs: int = PROBE_RUNS):
    """The calibration on the card: each probe builds the pair at its
    scale, runs tokenwise K = 1 n_runs times (the tokenwise fold; a warm
    run before the first probe only) and frees the pair."""
    fwd, ops = make_coupled_target(cfg_s, cfg_b)
    gen = spec_gen(cfg_s, cfg_b, "tokenwise", 1, fwd, ops)
    builds, first = [], [True]

    def be_at(s):
        draft, target, build_s = build_pair(cfg_s, cfg_b, s, device)
        builds.append(build_s)
        r = run_row(gen, draft, target, FOLD["tokenwise"], n_runs, device,
                    cfg_b.vocab_size, warm=first[0])
        first[0] = False
        del draft, target
        free(device)
        log(f"probe scale {s}: tokenwise BE {r['be']} +- {r['ci95']} "
            f"(pair built in {build_s:.1f}s)")
        return r["be"]

    scale, probes = calibrate_scale(be_at)
    log(f"calibrated scale={scale} probes={probes}")
    return scale, probes, builds


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    how = ap.add_mutually_exclusive_group(required=True)
    how.add_argument("--scale", type=float,
                     help="the trunk sharpening (skips the calibration)")
    how.add_argument("--calibrate", action="store_true",
                     help="find the scale whose tokenwise BE is 5.99 first")
    ap.add_argument("--rows", default="k1,k11,ar",
                    help="comma-separated rows: k1, k11, ar")
    args = ap.parse_args(argv)
    rows = [r for r in args.rows.split(",") if r]
    bad = set(rows) - {"k1", "k11", "ar"}
    if bad:
        ap.error(f"unknown rows {sorted(bad)}")
    if not torch.cuda.is_available():
        sys.exit("bench_main: no CUDA device")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    FD.FLASH_DECODE = FD.FUSED_ATTN = "auto"      # K8 stays off this path
    smi = card_line()
    print(smi, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.time()
    _build.lib("gptq_i8")
    log(f"kernels built and loaded in {time.time() - t0:.1f}s")

    cfg_s, cfg_b = ModelConfig.qwen2_05b(), ModelConfig.qwen2_14b()
    result = {"card": smi, "kind": torch.cuda.get_device_name(0),
              "gamma": GAMMA, "max_new": MAX_NEW, "runs": N_RUNS}
    if args.calibrate:
        scale, probes, builds = calibrate(cfg_s, cfg_b, device)
        result.update(calibrated=True, probes=probes, probe_build_s=builds)
    else:
        scale = args.scale
        result["calibrated"] = False
    result["scale"] = scale
    result.update(measure(rows, scale, cfg_s, cfg_b, device))
    for name, row in result["rows"].items():
        band = against_band(name, row)
        if band is not None:
            row["band"] = band
            log(f"{name}: BE {row['be']} "
                f"{'inside' if band['inside'] else 'outside'} the reference "
                f"band {band['low']}..{band['high']} (by {band['outside_by']})")
    log(f"done in {time.time() - T0:.1f}s")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
