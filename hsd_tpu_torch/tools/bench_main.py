"""The reference's main-path cell (`bench.py:59-138` and `:478-529`) on the
port, on one CUDA card: the asymmetric-int8 0.5B draft speculating for the
48-layer packed-int4 14B target coupled to the bf16 0.5B trunk
(`build_coupled_pair(0, qwen2_05b(), qwen2_14b(), lam=0.0,
logit_scale=S)`), gamma 10, 256 new tokens, temperature 1.0, the one
64-token prompt `(arange(64) % 1000) + 10`.

    python hsd_tpu_torch/tools/bench_main.py --scale 1.467 --rows k1,ar
    python hsd_tpu_torch/tools/bench_main.py --calibrate --rows k1
    python hsd_tpu_torch/tools/bench_main.py --scale 1.467 --rows k11
    python hsd_tpu_torch/tools/bench_main.py --scale 1.467 --rows serving
    python hsd_tpu_torch/tools/bench_main.py --rows gsm8k_parity
    python hsd_tpu_torch/tools/bench_main.py --rows eagle_serving \
        [--eagle-grid 1:4,1:1,2:4,2:1]
    python hsd_tpu_torch/tools/bench_main.py --rows realistic
    python hsd_tpu_torch/tools/bench_main.py --rows realistic_eagle

Rows (`--rows`, comma-separated):
  k1   hsd and tokenwise at K = 1;
  k11  hsd and tokenwise at K = 11, parallel multidraft (a 693-row target
       prefill and a 682-row draft prefill on the dequantize route, a
       121-row verify, an 11-row draft); before them the two prefills are
       timed apart with their peak allocation;
  ar   autoregressive sampling over 96 tokens on the coupled target;
  serving  the reference's `serving_0p5b` row (`bench.py:141-199`, called
       at `:583`; run last, after the 14B part is freed): the int8 0.5B
       draft against the pair's own bf16 0.5B trunk (`target.small`), hsd,
       gamma 5, K 1, temperature 1.0, 48 new tokens at most; `SlotEngine`
       with 8 slots, bucket 64, macro steps of 4 pool blocks with the
       on-device refill (8 staged entries); 32 requests drawn with numpy's default_rng(0) as
       bench.py draws them (32-63 prompt ids in [1, vocab - 2), a budget in
       [12, 48]); each engine serves one warm request (8 tokens) first.
       Continuous: all 32 submitted, then run_all; lockstep: waves of 8,
       run_all a wave. 3 reps, each with engines built anew; reported: the
       rep of the median ratio, every ratio, BE over the continuous run's
       requests (mean over blocks of accepts + 1, the warm request
       excluded), tok/s = committed tokens over the run_all wall seconds,
       the pool blocks each schedule ran (every slot's rows a block), its
       steps, requests admitted by the refill (refilled_total) and host
       reads, and the launch counts of each run.
The rows that build no 14B pair (they need no --scale; each builds its
own models after the 14B rows have freed theirs):
  gsm8k_parity  `bench.py:405-475`: the 2-layer byte-vocab pair (vocab 256,
       D 32; the target is the draft with its embedding x 1.3), 20
       questions x 25 reps through the port's `eval.gsm8k.run_eval`,
       gamma 4, 48 tokens, tokenwise against hsd: the TV of the
       first-digit answer laws and the port's own 400-permutation floor
       (p50, p95), beside the reference's (`gsm8k_parity_row`);
  eagle_serving  `bench.py:345-402`, uncut: `llama3_8b()` with
       `gptq_mxu_bf16`, the symmetric-int8 trunk and the v1 head as the
       bigram oracle (scale 6.0, lam 1.312), EagleSlotEngine with 8 slots,
       bucket 64, macro steps of 4 pool blocks with the on-device refill,
       hsd_ref; a warm request, then 24 requests x 96 tokens drawn with
       numpy's default_rng(0) as bench.py draws them; BE (the reference's:
       stats(), the warm request included) beside 3.978, its standard
       error over requests, tok/s, pool blocks, steps, refilled_total and
       host reads (`eagle_serving_row`); `--eagle-grid 1:4,1:1,2:4:greedy`
       runs it for each engine seed : pool blocks a macro [: mode, hsd_ref
       by default; greedy at temperature 0] on the one pair, each run
       with the sha256 of its
       requests' tokens, accepts and blocks (the first entry is the row's;
       every run listed under `grid`);
  realistic  `bench.py:206-336`: the reference's mixed-entropy language
       (its numpy seed), a 4L/256H target trained 1800 steps and a 2L/128H
       draft distilled 1800 steps at vocab 2048 in f32 (the port's own
       RNG), the draft temperature tau bisected toward tokenwise BE 5.99
       on 24-run probes, then 288 runs a method for tokenwise, blockwise
       and hsd: the uplifts over tokenwise with delta-method CIs, ratio_stats'
       alpha and frac_hard_disagree and the CEs, beside the reference's
       bands (`realistic_row`). A reading outside a band is reported, not
       re-seeded.
  realistic_eagle  `scripts/bench_realistic.py:223-292`: the realistic
       row's target (trained as there), an EAGLE-3 head 256 wide
       (intermediate 512, top_k 10, depth 6, 59 nodes) trained 1500 steps
       of 64 x 96 by the port's `train.eagle3` (lr 2e-3, 3 chained steps),
       then typical, hsd, hsd_ref and greedy through `make_eagle_generate`
       over 8 prompts x 128 tokens: BE +- CI95, tok/s, the accept
       histogram, hsd over typical (`realistic_eagle_row`). No bar: the
       script's figures are the paper's H100 telemetry on real models.
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
import collections
import dataclasses
import hashlib
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

if __package__ in (None, ""):            # run as a script from its path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine import make_autoregressive, make_generate
from hsd_tpu_torch.engine.kvcache import init_cache
from hsd_tpu_torch.engine.server import SlotEngine
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
# the serving row (bench.py:141-199, :583); the reference's ratio, its
# reps and BE (BENCH_r05.json; its tok/s were a TPU's and are not shown)
SRV_SLOTS, SRV_REQS, SRV_NEW, SRV_GAMMA, SRV_REPS = 8, 32, 48, 5, 3
SRV_BUCKET, SRV_MACRO, SRV_WARM_NEW, SRV_WARM_RID = 64, 4, 8, 10_000
# the slot scheduler's counters a serving row reports, over its timed run
SCHED = ("steps", "pool_blocks", "host_reads", "refilled_total")
SRV_REF = {"ratio": 1.256, "ratios": [1.245, 1.256, 1.261], "be": 4.66}
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
    small = target.small
    del target                      # the serving row needs no 14B part
    free(device)
    if "serving" in rows:
        out["rows"]["serving"] = srv = serving_row(draft, small, cfg_s,
                                                   device)
        log(f"serving (median-ratio rep): continuous {srv['cont_tok_s']} "
            f"tok/s, lockstep {srv['lock_tok_s']} tok/s, ratio "
            f"{srv['ratio']}, BE {srv['be']}, ratios {srv['ratios']}; the "
            f"reference: ratio {SRV_REF['ratio']} (reps "
            f"{SRV_REF['ratios']}), BE {SRV_REF['be']}")
    del draft, small
    free(device)
    return out


def serving_requests(vocab: int, reqs: int = SRV_REQS,
                     max_new: int = SRV_NEW) -> List[Tuple[List[int], int]]:
    """bench.py's requests (:162-166): numpy default_rng(0); for each, a
    prompt of integers(32, 64) ids in [1, vocab - 2), drawn after its
    length, then a budget in [max_new // 4, max_new]."""
    rng = np.random.default_rng(0)
    return [(rng.integers(1, vocab - 2, (int(rng.integers(32, 64)),))
             .tolist(), int(rng.integers(max_new // 4, max_new + 1)))
            for _ in range(reqs)]


def serving_row(draft, small, cfg_s: ModelConfig, device,
                n_slots: int = SRV_SLOTS, reqs: int = SRV_REQS,
                max_new: int = SRV_NEW, reps: int = SRV_REPS) -> dict:
    """bench.py's `_serving_row`: continuous against lockstep serving of
    the same requests on SlotEngine. Each request's generator is seeded by
    its id (SlotEngine.submit), so both schedules commit the same tokens."""
    eng_cfg = EngineConfig(
        verifier=VerifierConfig(method="hsd", gamma=SRV_GAMMA),
        max_new_tokens=max_new, temperature=1.0)
    ps = serving_requests(cfg_s.vocab_size, reqs, max_new)

    def build():
        e = SlotEngine(cfg_s, cfg_s, eng_cfg, n_slots=n_slots,
                       bucket=SRV_BUCKET, params_d=draft, params_t=small,
                       steps_per_dispatch=SRV_MACRO, admit_batch=n_slots,
                       device=device)
        e.submit(SRV_WARM_RID, ps[0][0], max_new=SRV_WARM_NEW)
        e.run_all()
        sync(device)
        return e

    def timed(run):
        """run(engine) on a warmed engine; the clock and the launch counters
        cover the run only, as bench.py times it."""
        eng = build()
        reset_launches()
        before = {k: getattr(eng, k) for k in SCHED}
        t0 = time.perf_counter()
        done = run(eng)
        sync(device)
        secs = time.perf_counter() - t0
        return (done, secs, launch_counts(),
                {k: getattr(eng, k) - v for k, v in before.items()})

    def continuous(eng):
        for rid, (p, mn) in enumerate(ps):
            eng.submit(rid, p, max_new=mn)
        return eng.run_all()

    def lockstep(eng):
        done = []
        for w in range(0, reqs, n_slots):
            for rid, (p, mn) in enumerate(ps[w:w + n_slots]):
                eng.submit(w + rid, p, max_new=mn)
            done.extend(eng.run_all())
        return done

    def check(done):
        if sorted(r.rid for r in done) != list(range(reqs)):
            raise AssertionError("serving: a request was lost")
        for r in done:
            if not (1 <= len(r.out_tokens) <= ps[r.rid][1] and all(
                    0 <= t < cfg_s.vocab_size for t in r.out_tokens)):
                raise AssertionError(f"serving: request {r.rid}'s tokens")
        return {r.rid: r.out_tokens for r in done}

    rows = []
    for i in range(reps):
        c_done, c_secs, c_launch, c_sched = timed(continuous)
        l_done, l_secs, l_launch, l_sched = timed(lockstep)
        c_pool, l_pool = c_sched["pool_blocks"], l_sched["pool_blocks"]
        c_toks, l_toks = check(c_done), check(l_done)
        c_n = sum(len(t) for t in c_toks.values())
        l_n = sum(len(t) for t in l_toks.values())
        blocks = sum(r.blocks for r in c_done)
        be = (sum(r.accepts for r in c_done) + blocks) / blocks
        cont, lock = c_n / c_secs, l_n / l_secs
        row = dict(ratio=cont / lock, cont_tok_s=cont, lock_tok_s=lock, be=be,
                   cont_tokens=c_n, lock_tokens=l_n, cont_s=c_secs,
                   lock_s=l_secs, blocks=blocks, pool_blocks_cont=c_pool,
                   pool_blocks_lock=l_pool, same_streams=c_toks == l_toks,
                   refilled_cont=c_sched["refilled_total"],
                   refilled_lock=l_sched["refilled_total"],
                   steps_cont=c_sched["steps"], steps_lock=l_sched["steps"],
                   host_reads_cont=c_sched["host_reads"],
                   host_reads_lock=l_sched["host_reads"],
                   launches_cont=c_launch, launches_lock=l_launch)
        rows.append(row)
        log(f"serving rep {i}: continuous {cont} tok/s ({c_n} tokens in "
            f"{c_secs}s), lockstep {lock} tok/s ({l_n} in {l_secs}s), "
            f"ratio {cont / lock}, BE {be} over {blocks} slot-blocks, pool "
            f"blocks {c_pool} / {l_pool} in {c_sched['steps']} / "
            f"{l_sched['steps']} steps, refilled_total "
            f"{c_sched['refilled_total']} / {l_sched['refilled_total']}, "
            f"host reads {c_sched['host_reads']} / {l_sched['host_reads']}, "
            f"the two schedules' streams identical: {row['same_streams']}; "
            f"launches continuous {c_launch}, lockstep {l_launch}")
    med = sorted(rows, key=lambda r: r["ratio"])[len(rows) // 2]
    return dict(med, ratios=[r["ratio"] for r in rows], reps=rows,
                reference=SRV_REF)


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


# ---------------------------------------------------------------------------
# the rows without the 14B pair: gsm8k_parity, eagle_serving, realistic
# ---------------------------------------------------------------------------

# bench.py's _gsm8k_parity_row (:405-475): the reference's numbers
# (BENCH_r05.json; its accuracies are of random byte models, shown as is)
PARITY_REF = {"answer_tv": 0.048, "n_outputs": 500, "noise_floor_tv50": 0.078,
              "noise_floor_tv95": 0.114}
PARITY_Q, PARITY_REPS, PARITY_GAMMA, PARITY_NEW = 20, 25, 4, 48
PARITY_PERMS = 400
PARITY_SHOTS = ("Question: 1 plus 1?\nLet's think step by step\n"
                "The answer is 2\n")


def parity_questions(n: int = PARITY_Q) -> List[dict]:
    return [{"question": f"A box holds {3 + i} pears and gains {2 + i} "
                         "more. How many pears are in the box?",
             "answer": f"#### {5 + 2 * i}"} for i in range(n)]


def first_digit(text: str) -> str:
    m = re.search(r"[0-9]", text or "")
    return m.group(0) if m else "none"


def law(cats: List[str]) -> dict:
    c = collections.Counter(cats)
    return {k: v / len(cats) for k, v in c.items()}


def tv_of(da: dict, db: dict) -> float:
    return 0.5 * sum(abs(da.get(k, 0) - db.get(k, 0))
                     for k in set(da) | set(db))


def permutation_floor(a: List[str], b: List[str],
                      perms: int = PARITY_PERMS) -> List[float]:
    """bench.py's noise floor: the TV between two random halves of the
    pooled outputs (numpy default_rng(0)), `perms` times."""
    pool = a + b
    rng = np.random.default_rng(0)
    out = []
    for _ in range(perms):
        perm = rng.permutation(len(pool))
        out.append(tv_of(law([pool[i] for i in perm[:len(a)]]),
                         law([pool[i] for i in perm[len(a):]])))
    return out


def gsm8k_parity_row(device, questions: int = PARITY_Q,
                     reps: int = PARITY_REPS, max_new: int = PARITY_NEW,
                     perms: int = PARITY_PERMS) -> dict:
    """bench.py's `_gsm8k_parity_row` on the port: the 2-layer byte-vocab
    pair (`tiny`, vocab 256, D 32; the target = the draft with its
    embedding x 1.3), `questions` x `reps` outputs a method through the
    port's run_eval (gamma 4, `max_new` tokens, seed 0), tokenwise
    against hsd: the first-digit answer law's TV and its permutation
    floor (p50, p95), beside the reference's."""
    from hsd_tpu_torch.eval.gsm8k import ByteTokenizer, EvalConfig, run_eval
    from hsd_tpu_torch.models import init_params

    cfg = ModelConfig.tiny(vocab_size=256, hidden_size=32,
                           intermediate_size=64, num_layers=2, num_heads=4,
                           num_kv_heads=2)
    pd = init_params(cfg, seed=0, device=device)
    pt = pd._replace(embed=pd.embed * 1.3)
    rows = [q for q in parity_questions(questions) for _ in range(reps)]
    out = {"n_outputs": len(rows)}
    cats = {}
    with tempfile.TemporaryDirectory() as tmp:
        for m in ("tokenwise", "hsd"):
            ev = EvalConfig(engine=EngineConfig(
                verifier=VerifierConfig(method=m, gamma=PARITY_GAMMA),
                max_new_tokens=max_new), out_dir=tmp, tag=m, seed=0)
            t0 = time.perf_counter()
            summary = run_eval(cfg, cfg, pd, pt, ByteTokenizer(), rows,
                               PARITY_SHOTS, ev, device=device)
            secs = time.perf_counter() - t0
            cats[m] = [first_digit(a) for a in summary["model_answers"]]
            out[m] = dict(acc=summary["accuracy"],
                          be=summary["block_efficiency"], seconds=secs,
                          law=law(cats[m]))
            log(f"gsm8k_parity {m}: {len(rows)} outputs in {secs:.1f}s, BE "
                f"{summary['block_efficiency']}, first-digit law "
                f"{out[m]['law']}")
    floor = permutation_floor(cats["tokenwise"], cats["hsd"], perms)
    out.update(answer_tv=tv_of(law(cats["tokenwise"]), law(cats["hsd"])),
               noise_floor_tv50=float(np.median(floor)),
               noise_floor_tv95=float(np.quantile(floor, 0.95)),
               reference=PARITY_REF)
    out["at_or_below_tv95"] = out["answer_tv"] <= out["noise_floor_tv95"]
    log(f"gsm8k_parity: answer TV {out['answer_tv']} against the port's "
        f"floor p50 {out['noise_floor_tv50']} p95 {out['noise_floor_tv95']} "
        f"(the reference: TV {PARITY_REF['answer_tv']}, floor "
        f"{PARITY_REF['noise_floor_tv50']} / {PARITY_REF['noise_floor_tv95']}"
        f" at N = {PARITY_REF['n_outputs']})")
    return out


# bench.py's _eagle_serving_row (:345-402), uncut; the reference's BE
# (BENCH_r05.json; its tok/s were a TPU's and are not shown)
EAGLE_REF_BE = 3.978
EAGLE_SLOTS, EAGLE_REQS, EAGLE_NEW = 8, 24, 96
EAGLE_BUCKET, EAGLE_MACRO = 64, 4
EAGLE_SCALE, EAGLE_LAM, EAGLE_WARM_RID = 6.0, 1.312, 10_000


def eagle_serving_requests(reqs: int = EAGLE_REQS, bucket: int = EAGLE_BUCKET
                           ) -> Tuple[List[int], List[List[int]]]:
    """bench.py's draws (:387-394): numpy default_rng(0); the warm
    request's `bucket` ids in [10, 1000), then for each request a length
    in [32, 64) and that many ids."""
    rng = np.random.default_rng(0)
    warm = rng.integers(10, 1000, (bucket,)).tolist()
    return warm, [rng.integers(10, 1000, (int(rng.integers(32, 64)),))
                  .tolist() for _ in range(reqs)]


def eagle_configs():
    """bench.py's EAGLE serving configuration: Llama-3.1-8B geometry, an
    EOS that is never drawn, bf16 operands at 129-1024 rows, the v1 head
    (draft vocab 32000, top_k 10, depth 6, 59 nodes)."""
    from hsd_tpu_torch.models.eagle import EagleConfig

    cfg = ModelConfig.llama3_8b()
    cfg = dataclasses.replace(cfg, eos_token_id=cfg.vocab_size,
                              gptq_mxu_bf16=True)
    ecfg = EagleConfig(
        hidden_size=cfg.hidden_size, target_hidden_size=cfg.hidden_size,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        vocab_size=cfg.vocab_size, draft_vocab_size=32000,
        intermediate_size=cfg.intermediate_size, rope_theta=cfg.rope_theta,
        top_k=10, depth=6, total_tokens=59, version=1)
    return cfg, ecfg


def ratio_se(acc: List[int], blocks: List[int]) -> float:
    """The standard error of BE = 1 + sum(acc) / sum(blocks) over
    requests (the ratio estimator's delta method)."""
    n, m = len(acc), sum(acc) / sum(blocks)
    if n < 2:
        return 0.0
    mean_b = sum(blocks) / n
    var = sum((a - m * b) ** 2 for a, b in zip(acc, blocks)) / (n - 1)
    return (var / n) ** 0.5 / mean_b


def eagle_serving_row(device, cfg=None, ecfg=None, n_slots: int = EAGLE_SLOTS,
                      reqs: int = EAGLE_REQS, max_new: int = EAGLE_NEW,
                      bucket: int = EAGLE_BUCKET,
                      grid: Sequence[tuple] = ((1, EAGLE_MACRO, "hsd_ref"),)
                      ) -> dict:
    """bench.py's `_eagle_serving_row` on the port, uncut: the int8 pair
    (`build_coupled_eagle_pair(0, ..., scale=6.0, lam=1.312,
    big_bits=8)`), EagleSlotEngine with `n_slots` slots, the bucket,
    4 pool steps a dispatch, hsd_ref, seed 1; a warm request (4 tokens),
    then `reqs` requests of `max_new` tokens. BE as the reference reads it
    (`stats()`, the warm request included) and over the timed requests
    alone, with its standard error over requests; tok/s = their committed
    tokens over run_all's wall seconds; the launches of the timed run.
    grid: (engine seed, pool blocks a macro, mode) triples, each a run on
    the one pair, with the sha256 of its requests' (tokens, accepts,
    blocks); the first is the row, every one is listed under `grid`."""
    from hsd_tpu_torch.engine.eagle_server import EagleSlotEngine
    from hsd_tpu_torch.eval.synthetic import (build_coupled_eagle_pair,
                                              make_coupled_eagle_target)

    if cfg is None:
        cfg, ecfg = eagle_configs()
    t0 = time.time()
    head, target = build_coupled_eagle_pair(0, cfg, ecfg, scale=EAGLE_SCALE,
                                            lam=EAGLE_LAM, big_bits=8,
                                            device=device)
    sync(device)
    build_s = time.time() - t0
    log(f"eagle_serving: pair built in {build_s:.1f}s")
    warm, prompts = eagle_serving_requests(reqs, bucket)
    runs = []
    for seed, macro, mode in grid:
        se = EagleSlotEngine(
            cfg, ecfg, EngineConfig(max_new_tokens=max_new,
                                    temperature=0.0 if mode == "greedy"
                                    else 1.0),
            n_slots=n_slots, bucket=bucket, params_t=target, params_e=head,
            mode=mode, seed=seed,
            target_forward=make_coupled_eagle_target(cfg, (-1,)),
            steps_per_dispatch=macro, admit_batch=n_slots, device=device)
        se.submit(EAGLE_WARM_RID, warm, max_new=4)
        se.run_all()                               # warm every path
        sync(device)
        reset_launches()
        for rid, p in enumerate(prompts):
            se.submit(rid, p, max_new=max_new)
        before = {k: getattr(se, k) for k in SCHED}
        t0 = time.perf_counter()
        done = se.run_all()
        sync(device)
        secs = time.perf_counter() - t0
        sched = {k: getattr(se, k) - v for k, v in before.items()}
        if sorted(r.rid for r in done) != list(range(reqs)):
            raise AssertionError("eagle_serving: a request was lost")
        for r in done:
            if not (1 <= len(r.out_tokens) <= max_new and all(
                    0 <= t < cfg.vocab_size for t in r.out_tokens)):
                raise AssertionError(
                    f"eagle_serving: request {r.rid}'s tokens")
        toks = sum(len(r.out_tokens) for r in done)
        blocks = sum(r.blocks for r in done)
        digest = hashlib.sha256(json.dumps(sorted(
            (r.rid, r.out_tokens, r.accepts, r.blocks) for r in done)
        ).encode()).hexdigest()[:16]
        run = dict(seed=seed, macro=macro, mode=mode, sha256=digest,
                   be=se.stats()["block_efficiency"],
                   be_requests=(sum(r.accepts for r in done) + blocks)
                   / blocks,
                   be_se=ratio_se([r.accepts for r in done],
                                  [r.blocks for r in done]),
                   tok_s=toks / secs, tokens=toks, seconds=secs,
                   blocks=blocks, launches=launch_counts(), **sched)
        runs.append(run)
        log(f"eagle_serving {mode} seed {seed}, {macro} pool blocks a macro "
            f"({reqs} x {max_new}, {n_slots} slots): BE {run['be']} (the timed "
            f"requests alone {run['be_requests']} +- {run['be_se']} SE; the "
            f"reference {EAGLE_REF_BE}), {toks} tokens in {secs}s = "
            f"{run['tok_s']} tok/s, {blocks} slot-blocks, "
            f"{sched['pool_blocks']} pool blocks in {sched['steps']} steps, "
            f"refilled_total {sched['refilled_total']}, host reads "
            f"{sched['host_reads']}, sha256 {digest}, launches "
            f"{run['launches']}")
        del se
    out = dict(runs[0], build_s=build_s, slots=n_slots, reqs=reqs,
               max_new=max_new, reference_be=EAGLE_REF_BE)
    if len(runs) > 1:
        out["grid"] = runs
    del head, target
    free(device)
    return out


# bench.py's _realistic_row (:206-336); the reference's numbers
# (BENCH_r05.json): BEs, the uplifts over tokenwise with their CI95s
REAL_REF = {"be": {"tokenwise": 6.315, "blockwise": 6.465, "hsd": 6.581},
            "uplift": {"hsd": (1.0421, 0.0359), "blockwise": (1.0238, 0.0357)},
            "tau": 1.406, "alpha": 0.8851, "frac_hard_disagree": 0.1051}
REAL_V, REAL_STEPS, REAL_FINAL, REAL_PROBE = 2048, 1800, 288, 24
REAL_NEW, REAL_PROMPTS, REAL_PLEN, REAL_RUN0, REAL_WARM = 256, 8, 64, 700, 999
# the last word of the reference's language key, fold_in(fold_in(
# PRNGKey(0), 40), 31), which make_language seeds numpy with: the port's
# language is the reference's, bit for bit
REAL_LANG_SEED = 3592766398
# the port's own seeds for the trained pair, the prompts and the probes
# (fold_seed(REAL_SEED, k) for bench.py's fold k)
REAL_SEED = 0


def realistic_configs(V: int = REAL_V, target_hidden: int = 256,
                      target_layers: int = 4, draft_hidden: int = 128,
                      draft_layers: int = 2):
    """bench.py's pair: a 4L/256H target and a 2L/128H draft, f32, untied,
    vocab 2048, EOS V - 1."""
    common = dict(vocab_size=V, num_heads=4, num_kv_heads=2,
                  dtype=torch.float32, tie_word_embeddings=False,
                  eos_token_id=V - 1)
    return (ModelConfig.tiny(hidden_size=target_hidden,
                             intermediate_size=2 * target_hidden,
                             num_layers=target_layers, **common),
            ModelConfig.tiny(hidden_size=draft_hidden,
                             intermediate_size=2 * draft_hidden,
                             num_layers=draft_layers, **common))


def uplift(rows: dict, m: str) -> Tuple[float, float]:
    """bench.py's delta-method uplift over tokenwise and its CI95."""
    r = rows[m]["be"] / rows["tokenwise"]["be"]
    ci = r * ((rows[m]["ci95"] / rows[m]["be"]) ** 2
              + (rows["tokenwise"]["ci95"] / rows["tokenwise"]["be"]) ** 2
              ) ** 0.5
    return r, ci


def calibrate_tau(be_at: Callable[[float], float],
                  target_be: float = TARGET_BE) -> float:
    """bench.py's tau search (:277-296): a probe at 1.0; while above the
    target, raise the upper end by 1.4x from 2.0; then up to 7 bisections
    until a probe lands within 0.1; the tau whose probe landed closest."""
    cal = []

    def probe(t):
        be = be_at(t)
        cal.append((t, be))
        return be

    lo, hi = 1.0, 2.0
    be = probe(1.0)
    if be > target_be:
        while be > target_be and hi < 6.0:
            be = probe(hi)
            if be > target_be:
                lo, hi = hi, hi * 1.4
        for _ in range(7):
            if abs(be - target_be) < 0.1:
                break
            tau = 0.5 * (lo + hi)
            be = probe(tau)
            if be > target_be:
                lo = tau
            else:
                hi = tau
    return min(cal, key=lambda tb: abs(tb[1] - target_be))[0], cal


def realistic_row(device, steps: int = REAL_STEPS, n_final: int = REAL_FINAL,
                  probe_runs: int = REAL_PROBE, max_new: int = REAL_NEW,
                  configs=None, lang_kw=None, batch: int = 64,
                  seq: int = 96) -> dict:
    """bench.py's `_realistic_row` on the port: the reference's language
    (REAL_LANG_SEED), a target trained `steps` steps and a draft distilled
    `steps` steps (the port's own RNG: seeds fold_seed(0, 32) and
    fold_seed(0, 33)), 8 prompts of 64 tokens (fold_seed(0, 34)); the
    draft's temperature tau bisected toward tokenwise BE 5.99 on
    `probe_runs`-run probes; then `n_final` runs a method for tokenwise,
    blockwise and hsd (gamma 10, `max_new` tokens; run i on prompt i % 8
    with generator fold_seed(0, 700 + i), one warm run first with
    fold_seed(0, 999)); the uplifts over tokenwise with delta-method CIs,
    ratio_stats' alpha and frac_hard_disagree (fold_seed(0, 35)), the
    CEs, beside the reference's bands."""
    from hsd_tpu_torch.eval.oracle import (distill_lm, make_language,
                                           ratio_stats, sample_tokens,
                                           scale_draft_temperature, train_lm)
    from hsd_tpu_torch.ops.sampling import fold_generator, fold_seed

    cfg_t, cfg_d = configs or realistic_configs()
    lang = make_language(REAL_LANG_SEED, vocab=cfg_t.vocab_size,
                         device=device, **(lang_kw or {}))
    t0 = time.time()
    tl = []
    pt, tce = train_lm(cfg_t, fold_seed(REAL_SEED, 32), lang, steps=steps,
                       batch=batch, seq=seq, device=device, losses=tl)
    train_s = time.time() - t0
    log(f"realistic: target trained {steps} steps in {train_s:.1f}s, CE "
        f"{tl[0]} -> {tce}")
    t0 = time.time()
    dl = []
    pd, dce = distill_lm(cfg_d, cfg_t, pt, fold_seed(REAL_SEED, 33), lang,
                         steps=steps, batch=batch, seq=seq, device=device,
                         losses=dl)
    distill_s = time.time() - t0
    log(f"realistic: draft distilled {steps} steps in {distill_s:.1f}s, "
        f"soft CE {dl[0]} -> {dce}")
    prompts = sample_tokens(fold_generator(REAL_SEED, 34, device=device),
                            lang, REAL_PROMPTS, REAL_PLEN)

    def gen_for(m):
        return make_generate(cfg_d, cfg_t, EngineConfig(
            verifier=VerifierConfig(method=m, gamma=GAMMA),
            max_new_tokens=max_new))

    def measure_runs(gen, pdt, n):
        gen(pdt, pt, prompts[0], REAL_PLEN,
            fold_generator(REAL_SEED, REAL_WARM, device=device))
        sync(device)
        accepts, toks, secs = [], 0, 0.0
        for i in range(n):
            g = fold_generator(REAL_SEED, REAL_RUN0 + i, device=device)
            t0 = time.perf_counter()
            res = gen(pdt, pt, prompts[i % REAL_PROMPTS], REAL_PLEN, g)
            sync(device)
            secs += time.perf_counter() - t0
            toks += res.ncommit
            accepts.append(res.accepts[:res.blocks].tolist())
        return row_stats(accepts, toks, secs)

    gen_tok = gen_for("tokenwise")

    def be_at(tau):
        r = measure_runs(gen_tok, scale_draft_temperature(pd, cfg_d, tau),
                         probe_runs)
        log(f"realistic probe tau {tau}: tokenwise BE {r['be']} +- "
            f"{r['ci95']}")
        return r["be"]

    t0 = time.time()
    tau, cal = calibrate_tau(be_at)
    cal_s = time.time() - t0
    pdt = scale_draft_temperature(pd, cfg_d, tau)
    rows = {}
    for m in ("tokenwise", "blockwise", "hsd"):
        r = measure_runs(gen_for(m), pdt, n_final)
        rows[m] = {k: r[k] for k in ("be", "ci95", "tok_s", "tokens",
                                     "seconds")}
        log(f"realistic {m} ({n_final} runs at tau {tau}): BE {r['be']} +- "
            f"{r['ci95']}, {r['tok_s']} tok/s (the reference: BE "
            f"{REAL_REF['be'][m]})")
    st = ratio_stats(cfg_d, cfg_t, pdt, pt, lang,
                     fold_generator(REAL_SEED, 35, device=device),
                     gamma=GAMMA)
    out = dict(rows=rows, tau=tau, cal=cal, alpha=st["alpha"],
               frac_hard_disagree=st["frac_hard_disagree"], target_ce=tce,
               distill_ce=dce, target_ce0=tl[0], distill_ce0=dl[0],
               train_s=train_s, distill_s=distill_s, calibrate_s=cal_s,
               steps=steps, n_final=n_final, probe_runs=probe_runs,
               reference=REAL_REF)
    for m in ("hsd", "blockwise"):
        r, ci = uplift(rows, m)
        ref, ref_ci = REAL_REF["uplift"][m]
        out[f"uplift_{m}"] = r
        out[f"uplift_{m}_ci95"] = ci
        out[f"uplift_{m}_inside_band"] = ref - ref_ci <= r <= ref + ref_ci
        log(f"realistic uplift {m} / tokenwise: {r} +- {ci} (the "
            f"reference's band {ref} +- {ref_ci}: "
            f"{'inside' if out[f'uplift_{m}_inside_band'] else 'outside'})")
    log(f"realistic: tau {tau}, probes {cal}, alpha {st['alpha']}, "
        f"frac_hard_disagree {st['frac_hard_disagree']}, CEs {tce} / {dce}")
    return out


# scripts/bench_realistic.py's eagle_rows (:223-292): the paper's H100
# telemetry on real models (80 GSM8K questions), the script's only figures;
# the JAX records hold no number for this row, so it carries no bar
EAGLE_REAL_REF = {"typical_be": 4.217, "hsd_be": 4.608, "uplift": 1.093,
                  "typical_hist": [.203, .121, .109, .098, .080, .072, .317],
                  "hsd_hist": [.138, .104, .113, .106, .092, .093, .354],
                  "source": "EAGLE-3H/results/h100_*/*_info.jsonl"}
EAGLE_REAL_STEPS, EAGLE_REAL_NEW, EAGLE_REAL_INTER = 1500, 128, 512
EAGLE_MODES = ("typical", "hsd", "hsd_ref", "greedy")


def realistic_eagle_row(device, steps: int = REAL_STEPS,
                        head_steps: int = EAGLE_REAL_STEPS,
                        max_new: int = EAGLE_REAL_NEW, configs=None,
                        lang_kw=None, batch: int = 64, seq: int = 96,
                        head_inter: int = EAGLE_REAL_INTER) -> dict:
    """scripts/bench_realistic.py's `eagle_rows` on the port: the realistic
    row's language and target (trained `steps` steps from fold_seed(0,
    32)), then an EAGLE-3 head as wide as the target (intermediate
    `head_inter`, top_k 10, depth 6, 59 nodes, f32; init seed
    fold_seed(0, 8)) trained `head_steps` steps by `train.eagle3.
    make_train_step` (TrainConfig(steps=3, lr=2e-3, warmup min(100,
    max(1, head_steps // 5)), total head_steps), batches of `batch` x
    `seq` from fold_seed(17, i) for step i, the JAX script's key 17). Then
    typical, hsd, hsd_ref and greedy through `make_eagle_generate` over the
    realistic row's 8 prompts of 64 tokens, `max_new` tokens each (one warm
    run with fold_seed(0, 900), run i with fold_seed(0, 300 + i)): BE (mean
    accepts + 1 over every block) with a CI95 over the per-prompt means,
    tok/s, the accept histogram, and hsd's BE over typical's. The
    script's reference figures are the paper's H100 telemetry on real
    models; the row carries no bar."""
    from hsd_tpu_torch.engine.eagle_engine import (default_feature_layers,
                                                   make_eagle_generate)
    from hsd_tpu_torch.eval.oracle import (make_language, sample_tokens,
                                           train_lm)
    from hsd_tpu_torch.models.eagle import EagleConfig, init_eagle_params
    from hsd_tpu_torch.ops.sampling import fold_generator, fold_seed
    from hsd_tpu_torch.train.eagle3 import (TrainConfig, init_train_state,
                                            make_train_step)

    cfg_t, _ = configs or realistic_configs()
    lang = make_language(REAL_LANG_SEED, vocab=cfg_t.vocab_size,
                         device=device, **(lang_kw or {}))
    t0 = time.time()
    tl = []
    pt, tce = train_lm(cfg_t, fold_seed(REAL_SEED, 32), lang, steps=steps,
                       batch=batch, seq=seq, device=device, losses=tl)
    train_s = time.time() - t0
    log(f"realistic_eagle: target trained {steps} steps in {train_s:.1f}s, "
        f"CE {tl[0]} -> {tce}")
    D = cfg_t.hidden_size
    ecfg = EagleConfig(hidden_size=D, target_hidden_size=D,
                       num_heads=cfg_t.num_heads,
                       num_kv_heads=cfg_t.num_kv_heads,
                       vocab_size=cfg_t.vocab_size,
                       draft_vocab_size=cfg_t.vocab_size,
                       intermediate_size=head_inter, top_k=10, depth=6,
                       total_tokens=59, dtype=torch.float32,
                       rope_theta=cfg_t.rope_theta)
    tc = TrainConfig(steps=3, lr=2e-3,
                     warmup_steps=min(100, max(1, head_steps // 5)),
                     total_steps=head_steps, max_len=seq)
    state = init_train_state(init_eagle_params(
        ecfg, seed=fold_seed(REAL_SEED, 8), device=device), tc)
    hstep = make_train_step(cfg_t, ecfg, tc, default_feature_layers(cfg_t))
    mask = torch.ones((batch, seq), device=device)
    hl = []
    sync(device)
    t0 = time.time()
    for i in range(head_steps):
        ids = sample_tokens(fold_generator(17, i, device=device), lang,
                            batch, seq)
        state, metrics = hstep(state, pt, ids, mask)
        if i in (0, head_steps - 1):
            hl.append({k: float(v) for k, v in metrics.items()})
    sync(device)
    head_s = time.time() - t0
    pe = type(state.params)(*(None if v is None else v.detach()
                              for v in state.params))
    log(f"realistic_eagle: head trained {head_steps} steps in {head_s:.1f}s "
        f"({1e3 * head_s / head_steps:.2f} ms a step): loss {hl[0]['loss']} "
        f"-> {hl[-1]['loss']}, acc_0 {hl[0]['acc_0']} -> {hl[-1]['acc_0']}")
    prompts = sample_tokens(fold_generator(REAL_SEED, 34, device=device),
                            lang, REAL_PROMPTS, REAL_PLEN)
    eng = EngineConfig(max_new_tokens=max_new, temperature=1.0)
    modes = {}
    for mode in EAGLE_MODES:
        egen = make_eagle_generate(cfg_t, ecfg, eng, mode=mode)
        egen(pt, pe, prompts[0], REAL_PLEN,
             fold_generator(REAL_SEED, 900, device=device))
        sync(device)
        accepts, per_prompt, toks, secs = [], [], 0, 0.0
        for i in range(REAL_PROMPTS):
            g = fold_generator(REAL_SEED, 300 + i, device=device)
            t0 = time.perf_counter()
            r = egen(pt, pe, prompts[i], REAL_PLEN, g)
            sync(device)
            secs += time.perf_counter() - t0
            toks += r.ncommit
            a = r.accepts[:r.blocks].tolist()
            accepts.extend(a)
            if a:
                per_prompt.append(statistics.mean(x + 1 for x in a))
        hist = np.bincount(np.clip(accepts, 0, None), minlength=7)
        ci = (1.96 * statistics.stdev(per_prompt) / len(per_prompt) ** 0.5
              if len(per_prompt) > 1 else 0.0)
        modes[mode] = dict(be=statistics.mean(x + 1 for x in accepts),
                           be_ci95=ci, tok_s=toks / secs, tokens=toks,
                           seconds=secs, blocks=len(accepts),
                           accept_hist=(hist / max(len(accepts), 1)).tolist())
        log(f"realistic_eagle {mode}: BE {modes[mode]['be']} +- {ci}, "
            f"{modes[mode]['tok_s']} tok/s, accept hist "
            f"{modes[mode]['accept_hist']}")
    out = dict(modes=modes, uplift_hsd_vs_typical=modes["hsd"]["be"]
               / modes["typical"]["be"], target_ce=tce, target_ce0=tl[0],
               train_s=train_s, head_s=head_s, head_steps=head_steps,
               head_metrics=hl, steps=steps, reference=EAGLE_REAL_REF)
    log(f"realistic_eagle: hsd / typical BE {out['uplift_hsd_vs_typical']} "
        f"(the paper's H100 telemetry {EAGLE_REAL_REF['uplift']}; no bar)")
    return out


EXTRA_ROWS = {"gsm8k_parity": gsm8k_parity_row,
              "eagle_serving": eagle_serving_row,
              "realistic": realistic_row,
              "realistic_eagle": realistic_eagle_row}
PAIR_ROWS = ("k1", "k11", "ar", "serving")


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    how = ap.add_mutually_exclusive_group()
    how.add_argument("--scale", type=float,
                     help="the trunk sharpening (skips the calibration)")
    how.add_argument("--calibrate", action="store_true",
                     help="find the scale whose tokenwise BE is 5.99 first")
    ap.add_argument("--rows", default="k1,k11,ar",
                    help="comma-separated rows: k1, k11, ar, serving, "
                         "gsm8k_parity, eagle_serving, realistic, "
                         "realistic_eagle")
    ap.add_argument("--eagle-grid", default=f"1:{EAGLE_MACRO}",
                    help="eagle_serving's runs: comma-separated engine "
                         "seed:pool blocks a macro[:mode] entries")
    args = ap.parse_args(argv)
    rows = [r for r in args.rows.split(",") if r]
    bad = set(rows) - set(PAIR_ROWS) - set(EXTRA_ROWS)
    if bad:
        ap.error(f"unknown rows {sorted(bad)}")
    pair_rows = [r for r in rows if r in PAIR_ROWS]
    if pair_rows and args.scale is None and not args.calibrate:
        ap.error(f"rows {pair_rows} need --scale or --calibrate")
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
    if "eagle_serving" in rows:
        _build.lib("gptq_mma")
    log(f"kernels built and loaded in {time.time() - t0:.1f}s")

    result = {"card": smi, "kind": torch.cuda.get_device_name(0),
              "gamma": GAMMA, "max_new": MAX_NEW, "runs": N_RUNS, "rows": {}}
    if pair_rows:
        cfg_s, cfg_b = ModelConfig.qwen2_05b(), ModelConfig.qwen2_14b()
        if args.calibrate:
            scale, probes, builds = calibrate(cfg_s, cfg_b, device)
            result.update(calibrated=True, probes=probes,
                          probe_build_s=builds)
        else:
            scale = args.scale
            result["calibrated"] = False
        result["scale"] = scale
        result.update(measure(pair_rows, scale, cfg_s, cfg_b, device))
    for name in rows:
        if name in EXTRA_ROWS:
            t0 = time.time()
            kw = {}
            if name == "eagle_serving":
                kw["grid"] = [
                    (int(e[0]), int(e[1]), e[2] if len(e) > 2 else "hsd_ref")
                    for e in (x.split(":") for x in args.eagle_grid.split(","))]
            result["rows"][name] = EXTRA_ROWS[name](device, **kw)
            log(f"row {name} done in {time.time() - t0:.1f}s")
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
