"""One run of a cell: the served pair built from the seed, the closed loop
warmed up to the mix's completions, the measured window, the check, and
the metrics.

One request is served alone first (`prime`: kernels built or loaded,
every shape run once). Then the closed loop: `clients` clients each send
their next request the moment their last one completes (no think time). A request's noise comes
from its own generator, seeded by the run's seed and the request's index.
The window opens after `warmup_completions` completions and closes at the
end of the first engine step that ends past `seconds`; each end reads the
engine's counters once.

End-to-end metrics (tracing off, over the whole window):
  serve_tok_s       tokens committed in the window (the harvested
                    requests' and the in-flight slots' alike, counted at
                    both ends) over the window's seconds
  tpot_p90_ms       the 90th percentile over the requests completed in the
                    window of (completion - submission) / output tokens
  block_efficiency  tokens the verifier committed (accepted + 1 a block)
                    over the slot-blocks that live slots ran in the window
  setup_s           process start to the window's opening
With tracing, the profiler records the window's first `TRACE_SLICE_S`
seconds (whole steps) and the per-layer readers (`metrics/`) read it.
"""
from __future__ import annotations

import gc
import json
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from hsd_tpu_torch.config import EngineConfig, VerifierConfig
from hsd_tpu_torch.engine.server import SlotEngine

from . import check, costs, stats
from . import trace as tracing
from .instrument import SPANS, Instrument
from .traffic import Traffic

TRACE_SLICE_S = 10.0
WARMUP_TIMEOUT_S = 240.0
CHECK_SLOTS, CHECK_BLOCKS = 8, 3   # slots drawn, blocks captured a slot
CAPTURE_STEP_LIMIT = 64
PRIME_RID = 1 << 40      # no request of the loop has this index
PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"


class Loop:
    """The closed loop's clients around one engine."""

    def __init__(self, engine, traffic: Traffic, seed: int, device):
        self.engine, self.traffic = engine, traffic
        self.seed, self.dev = int(seed), torch.device(device)
        self.next, self.sub, self.budget, self.prompt = 0, {}, {}, {}
        self.done: List[dict] = []
        for _ in range(traffic.clients):
            self.submit()

    def submit(self):
        r = self.traffic.request(self.next)
        seed = int(np.random.SeedSequence([self.seed, 2, r.index])
                   .generate_state(1, np.uint64)[0]) >> 1
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        self.engine.submit(r.index, r.prompt, max_new=r.max_new,
                           generator=gen)
        self.sub[r.index], self.budget[r.index] = time.perf_counter(), \
            r.max_new
        self.prompt[r.index] = r.prompt
        self.next += 1

    def step(self):
        out = self.engine.step()
        t = time.perf_counter()
        V, eos = self.engine.cfg_d.vocab_size, self.engine.eos
        for req in out:
            toks, cap = req.out_tokens, self.budget.pop(req.rid)
            ok = (1 <= len(toks) <= cap and all(0 <= x < V for x in toks)
                  and (len(toks) == cap or toks[-1] == eos))
            self.done.append(dict(rid=req.rid, t=t, sub=self.sub.pop(req.rid),
                                  n=len(toks), ok=ok, acc=req.accepts,
                                  blk=req.blocks, toks=list(toks), cap=cap,
                                  prompt=self.prompt.pop(req.rid)))
            self.submit()
        return out

    def counters(self) -> dict:
        """Tokens committed so far (harvested plus in flight, each slot's
        capped at its budget), and the verifier's accepted tokens and
        slot-blocks so far; one device read."""
        eng, pool = self.engine, self.engine.pool
        occ = [s for s in range(eng.n_slots) if eng.slot_rid[s] >= 0]
        vals = torch.stack([pool.length, pool.max_new, pool.acc_sum,
                            pool.blk_cnt]).tolist()
        tokens = eng.total_committed + sum(
            min(vals[0][s] - eng.bucket, vals[1][s]) for s in occ)
        acc = sum(d["acc"] for d in self.done) + sum(vals[2][s] for s in occ)
        blk = sum(d["blk"] for d in self.done) + sum(vals[3][s] for s in occ)
        return dict(tokens=tokens, acc=acc, blk=blk, t=time.perf_counter())


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prime(engine, traffic: Traffic, seed: int, device):
    """One request served alone before the loop's clients start: the
    kernels are built (or loaded) and the prefill, block and harvest
    shapes run once, so that no request of the loop waits on a build."""
    r = traffic.request(0)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 62)
    engine.submit(PRIME_RID, r.prompt, max_new=1, generator=gen)
    deadline = time.perf_counter() + WARMUP_TIMEOUT_S
    while not engine.step() and time.perf_counter() < deadline:
        pass


def choose_slots(seed: int, n_slots: int, k: int, lengths: List[int],
                 live: List[bool]) -> List[int]:
    """k slots drawn from the seed, one from each of k runs of consecutive
    slots, the longest live slot taking its run's place."""
    rng = np.random.default_rng([int(seed), 3])
    bounds = np.linspace(0, n_slots, k + 1).astype(int)
    pick = [int(rng.integers(a, b)) for a, b in zip(bounds[:-1], bounds[1:])]
    cand = [s for s in range(n_slots) if live[s]]
    if cand:
        top = max(cand, key=lambda s: lengths[s])
        run = int(np.searchsorted(bounds, top, side="right")) - 1
        pick[run] = top
    return pick


def peaks_of(kind: str) -> Optional[dict]:
    with open(PEAKS) as f:
        return json.load(f).get(kind)


def run_cell(bench, cell: str, seed: int, seconds: float, traced: bool,
             device, t_start: float, fault: Optional[Callable] = None,
             post_faults: Optional[Dict[str, Callable]] = None) -> dict:
    """One run. Returns {"result": the result line's object, "lines":
    [(number, value, limit, ok)], "numbers": every compared number}.
    fault: planted for the whole run (`harness/faults.py`); post_faults:
    each planted after the window for blocks captured and judged apart
    (their numbers under "faults")."""
    wl = bench.workload(cell)
    spec, cmod = bench.config(wl["config"])
    mix = bench.traffic(wl["traffic"])
    e = wl["engine"]
    dev = torch.device(device)
    if e["num_drafts"] != 1:
        raise ValueError("the check covers one draft a slot (num_drafts 1)")
    served = cmod.build(spec, seed, dev, e["num_drafts"])
    traffic = Traffic(mix, seed, served.cfg_target.vocab_size)
    ecfg = EngineConfig(
        verifier=VerifierConfig(method=e["method"], gamma=e["gamma"],
                                num_drafts=e["num_drafts"]),
        max_new_tokens=traffic.max_new, temperature=e["temperature"])
    inst = Instrument(traced, dev)
    engine = SlotEngine(
        served.cfg_draft, served.cfg_target, ecfg, n_slots=e["slots"],
        bucket=traffic.bucket, params_d=served.params_draft,
        params_t=served.params_target, admit_batch=e["admit_batch"],
        target_forward=inst.wrap_target(served.target_forward),
        target_cache_ops=served.target_cache_ops,
        steps_per_dispatch=e["steps_per_dispatch"], device=dev)
    inst.attach(engine, served.target)
    try:
        if fault is not None:
            fault(engine, served, inst)
        return _serve(bench, cell, wl, served, traffic, engine, inst, seed,
                      seconds, traced, dev, t_start, post_faults or {})
    finally:
        inst.detach()


def _capture(engine, inst, loop, seed, n_slots):
    """Blocks of slots drawn from the seed, captured for the check."""
    pool = engine.pool
    st = torch.stack([pool.length, pool.live.long()]).tolist()
    slots = choose_slots(seed, n_slots, min(CHECK_SLOTS, n_slots), st[0],
                         [bool(x) for x in st[1]])
    inst.start_capture(slots, CHECK_BLOCKS)
    for _ in range(CAPTURE_STEP_LIMIT):
        if inst.capture_left <= 0:
            break
        loop.step()
    return slots, inst.records


def _serve(bench, cell, wl, served, traffic, engine, inst, seed, seconds,
           traced, dev, t_start, post_faults):
    e = wl["engine"]
    prime(engine, traffic, seed, dev)
    loop = Loop(engine, traffic, seed, dev)
    deadline = time.perf_counter() + WARMUP_TIMEOUT_S
    while (len(loop.done) < traffic.warmup
           and time.perf_counter() < deadline):
        loop.step()
    prof, slice_s = None, None
    if traced:                        # the profiler starts up in set-up
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        inst.recording = True
    _sync(dev)
    c0 = loop.counters()
    t_open = c0["t"]
    setup_s = t_open - t_start
    n_warm = len(loop.done)
    inst.snapshots = []
    while time.perf_counter() - t_open < seconds:
        loop.step()
        if prof is not None and slice_s is None and \
                time.perf_counter() - t_open >= min(TRACE_SLICE_S, seconds):
            _sync(dev)
            slice_s = time.perf_counter() - t_open
            inst.recording = False
            prof.__exit__(None, None, None)
    if prof is not None and slice_s is None:
        _sync(dev)
        slice_s = time.perf_counter() - t_open
        inst.recording = False
        prof.__exit__(None, None, None)
    c1 = loop.counters()
    snapshots, inst.snapshots = inst.snapshots, None
    window_s = c1["t"] - t_open
    in_window = [d for d in loop.done[n_warm:] if d["t"] <= c1["t"]]

    # after the window: blocks of the drawn slots, captured for the check
    slots, records = _capture(engine, inst, loop, seed, e["slots"])
    faulted = {}
    for name, plant in post_faults.items():
        undo = plant(engine, served, inst)
        faulted[name] = _capture(engine, inst, loop, seed, e["slots"])[1]
        undo()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    pool_state = dict(blocks=inst.blocks, admissions=inst.admissions,
                      totals={k: tuple(v) for k, v in inst.totals.items()})
    t_red = time.perf_counter()
    reduced = tracing.reduce(tracing.export(prof), SPANS) if prof else None
    t_red = time.perf_counter() - t_red
    del engine, loop.engine
    inst.engine = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers, refl = check.compare(served, e["temperature"], records, dev)
    numbers.update(check.harvest_numbers(snapshots, in_window,
                                         traffic.bucket, served.cfg_target
                                         .eos_token_id))
    del snapshots
    t_check = time.perf_counter() - t_check
    fault_numbers = {}
    for name, recs in faulted.items():
        fault_numbers[name] = check.compare(served, e["temperature"], recs,
                                            dev)[0]
    attempted = len(in_window)
    failed = sum(not d["ok"] for d in in_window)
    correct, lines = check.verdict(numbers, wl["limits"])
    correct = correct and attempted > 0 and failed == 0

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    extra = {}
    if not traced:
        values = end_to_end(c0, c1, window_s, in_window, setup_s)
        wanted = bench.metrics_of(cell, "end_to_end")
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in wanted}
    else:
        ctx = context(served, e, pool_state, reduced, slice_s,
                      peaks_of(kind))
        metrics = {}
        for m in bench.metrics_of(cell, "per_layer"):
            v = bench.metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if reduced is not None:
            device["busy_s"] = reduced["busy_s"]
            device["window_s"] = slice_s
            extra["breakdown"] = {"device_ops": reduced["device_ops"],
                                  "idle_gaps": reduced["idle_gaps"]}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device,
              **extra,
              "check": {k: {"value": v, "limit": lim}
                        for k, v, lim, _ in lines}}
    info = dict(window_s=window_s, completed=attempted, warm=n_warm,
                records=numbers.get("records", 0),
                commit_ties=numbers.get("commit_ties", 0),
                maxima={k: numbers.get(k + "_max") for k in
                        ("draft_tv", "target_tv", "big_logit_err")},
                harvest_checked=numbers.get("harvest_checked"),
                target_entropy=numbers.get("target_entropy"),
                slots=slots, trace_reduce_s=t_red, check_s=t_check,
                blocks=len(inst.blocks), admissions=len(inst.admissions))
    return {"result": result, "lines": lines, "numbers": numbers,
            "info": info, "served": served, "records": records,
            "refl": refl, "temperature": e["temperature"],
            "faults": fault_numbers}


def end_to_end(c0, c1, window_s, in_window, setup_s) -> Dict[str, float]:
    blk = c1["blk"] - c0["blk"]
    tpot = [(d["t"] - d["sub"]) / d["n"] * 1e3 for d in in_window if d["n"]]
    return {"serve_tok_s": (c1["tokens"] - c0["tokens"]) / window_s,
            "tpot_p90_ms": stats.percentile(tpot, 90) if tpot else None,
            "block_efficiency": ((c1["acc"] - c0["acc"]) + blk) / blk
            if blk else None,
            "setup_s": setup_s}


def work_of(served) -> Dict[str, Callable]:
    """{trunk: work(seqs, head) -> (ops, bytes)}: the configuration's own
    where it gives one (`coupled.Served.work`), else `costs.forward` over
    `costs.trunk` of the trunk's shapes and storage."""
    own = served.work or {}

    def default(m):
        tr = costs.trunk(served.shapes[m], served.quant[m])
        return lambda seqs, head: costs.forward(tr, seqs, head=head)
    return {m: own[m] if m in own else default(m)
            for m in ("draft", "small", "big")}


def context(served, e, pool_state, reduced, slice_s, peaks):
    """What the per-layer readers read: the traced slice's spans, device
    times (by harness or program span, and by kernel name), and the work
    of every forward in it (`work_of`)."""
    gamma = e["gamma"]
    fwd = work_of(served)
    work = {"verify": [], "draft": [], "prefill": []}
    for b in pool_state["blocks"]:
        live = [s for s, on in enumerate(b["live"]) if on]
        ctxs = [b["length"][s] - b["start"][s] for s in live]
        seqs = [(gamma + 1, c - 1) for c in ctxs]
        o1, b1 = fwd["big"](seqs, True)
        o2, b2 = fwd["small"](seqs, True)
        work["verify"].append((o1 + o2, b1 + b2))
        for j in range(gamma):
            steps = [(2, c - 2) if j == 0 else (1, c - 1 + j) for c in ctxs]
            work["draft"].append(fwd["draft"](steps, True))
    for n in pool_state["admissions"]:
        o1, b1 = fwd["big"]([(n - 1, 0)], False)
        o2, b2 = fwd["small"]([(n - 1, 0)], False)
        o3, b3 = fwd["draft"]([(n - 2, 0)], False)
        work["prefill"].append((o1 + o2 + o3, b1 + b2 + b3))
    return SimpleNamespace(slice_s=slice_s, spans=pool_state["totals"],
                           trace=reduced, work=work, peaks=peaks,
                           blocks=len(pool_state["blocks"]),
                           admissions=len(pool_state["admissions"]))
