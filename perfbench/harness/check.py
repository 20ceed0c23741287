"""The comparison that decides `correct`, on blocks that the timed path ran
after the window closed (`Instrument` capture), for slots drawn from the
seed.

For each captured (slot, block), the plain reference (`reference/model.py`,
or the configuration's own where it gives one; float32, from the raw codes
and scales) runs the slot's committed tokens
(the unpadded prompt and everything served so far) and the block's gamma
draft tokens through the draft, the small trunk and the big trunk, and
reads the logits at the block's gamma + 1 positions. The numbers:

  draft_tv       total variation between the draft law the block sampled
                 from and softmax(reference draft logits / T), at the
                 90th percentile of the positions
  target_tv      the same for the coupled target law the verifier read
  big_logit_err  |program - reference| of the big trunk's verify logits,
                 largest over the vocabulary, over the reference row's
                 standard deviation, at the 90th percentile of the positions
  commit_off     blocks whose committed tokens (the slot's tokens and
                 length after the block) differ from the reference
                 verifier's decision on the block's own draft, laws and
                 noise (`reference/verify.py`), a tie within 1e-4 of a
                 threshold excepted
  harvest_off    requests completed in the window whose output (as the
                 server harvested it) differs from the tokens the pool
                 committed for them: the last snapshot of the pool in the
                 window whose row holds the request's prompt, from the
                 bucket to its length, cut after the first EOS and at the
                 request's budget (none found counts as differing)
The law numbers read the 90th percentile of the ~260 positions a run
compares, so a fault in a tenth of them shows: the largest position
swings from seed to seed (on a few positions the program and the float8
control alike read ~20 in big_logit_err), the percentile does not
(`PERF.md` section 2).

`control` runs the same with the reference in float8 in the program's
place (every product's operands rounded to e4m3; a configuration's own
reference is called with precision "fp8").
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.reference import model as ref
from perfbench.reference import verify as rverify

from .stats import percentile

TIE = 1e-4
AT = 90          # the percentile of the positions that a law number reads
NUMBERS = ("draft_tv", "target_tv", "big_logit_err", "commit_off",
           "harvest_off")


def _sequences(records):
    seqs, wanted = [], []
    for r in records:
        committed = r["tokens"][r["start"]:]
        seqs.append(committed + r["draft"].tolist())
        n = len(committed)
        wanted.append(list(range(n - 1, n + r["draft"].shape[0])))
    return seqs, wanted


def reference_logits(served, records, device, precision="f32"):
    """{model: [per record: logits [gamma + 1, V]]} for draft, small, big:
    the configuration's own reference of a trunk where it gives one
    (`coupled.Served.reference`), else `reference/model.logits`."""
    seqs, wanted = _sequences(records)
    own = served.reference or {}
    return {m: own.get(m, ref.logits)(served.shapes[m], served.raw[m], seqs,
                                      wanted, precision=precision,
                                      device=device)
            for m in ("draft", "small", "big")}


def law_numbers(served, temperature: float, records, refl, port) -> dict:
    """draft_tv, target_tv and big_logit_err of `port` ({"draft": [q],
    "p": [p], "big": [logits]} per record) against the reference logits,
    with each record's own readings under "detail"."""
    dtv, ttv, errs, ent, detail = [], [], [], [], []
    for i, r in enumerate(records):
        g = r["draft"].shape[0]
        q_ref = torch.softmax(refl["draft"][i][:g] / temperature, -1)
        p_ref = ref.coupled_probs(refl["small"][i], refl["big"][i],
                                  served.lam, temperature)
        d = ref.tv(port["draft"][i].to(q_ref.device), q_ref)
        t = ref.tv(port["p"][i].to(p_ref.device), p_ref)
        e = ref.rel_err(port["big"][i].to(refl["big"][i].device),
                        refl["big"][i]).tolist()
        ent.extend((-(p_ref * torch.log(p_ref.clamp(min=1e-38))).sum(-1)
                    ).tolist())
        dtv.extend(d.tolist())
        ttv.extend(t.tolist())
        errs.extend(e)
        detail.append({"slot": r["slot"], "n": r["length"] - r["start"],
                       "draft_tv": [round(float(x), 4) for x in d],
                       "target_tv": [round(float(x), 4) for x in t],
                       "big_err": [round(x, 4) for x in e]})
    return {"draft_tv": percentile(dtv, AT), "target_tv": percentile(ttv, AT),
            "big_logit_err": percentile(errs, AT),
            "draft_tv_max": max(dtv), "target_tv_max": max(ttv),
            "big_logit_err_max": max(errs),
            "target_entropy": sum(ent) / len(ent), "detail": detail}


def commit_numbers(records) -> dict:
    off = ties = 0
    for r in records:
        d = rverify.hsd(r["draft"], r["q"], r["p"], r["u"], r["u2"],
                        r["gumbel"])
        n = d.n
        got = r["post_tokens"][:r["post_length"] - r["length"]]
        same = got == d.tokens and r["post_length"] - r["length"] == n + 1
        if not same:
            if d.margin < TIE:
                ties += 1
            else:
                off += 1
    return {"commit_off": off, "commit_ties": ties}


def harvest_numbers(snapshots, done: List[dict], bucket: int,
                    eos: int) -> dict:
    """harvest_off of the requests `done` ({"prompt", "toks", "cap"}) against
    the pool's snapshots [(tokens [slots, S], lengths [slots])]."""
    if not snapshots:
        return {"harvest_off": len(done), "harvest_checked": len(done)}
    toks = torch.stack([t for t, _ in snapshots]).cpu().numpy()
    lens = torch.stack([n for _, n in snapshots]).cpu().numpy()
    last = {}
    for b in range(toks.shape[0]):
        for s in range(toks.shape[1]):
            last[toks[b, s, :bucket].tobytes()] = (b, s)
    off = 0
    for d in done:
        ids = list(d["prompt"])[-bucket:]
        key = np.array([0] * (bucket - len(ids)) + ids,
                       dtype=toks.dtype).tobytes()
        at = last.get(key)
        if at is None:
            off += 1
            continue
        row = toks[at][bucket:int(lens[at])].tolist()
        if eos in row:
            row = row[:row.index(eos) + 1]
        off += row[:d["cap"]] != list(d["toks"])
    return {"harvest_off": off, "harvest_checked": len(done)}


def compare(served, temperature: float, records: List[dict], device):
    """The numbers of the captured records (the program's outputs against
    the float32 reference). Returns (numbers, reference logits)."""
    whole = [r for r in records if "q" in r and "big" in r]
    if len(whole) < len(records) or not records:
        # a block that ran no verifier or no target verify has no output
        # to judge: no run with one is correct
        return {"records": 0, "uncaptured": len(records) - len(whole)}, None
    refl = reference_logits(served, records, device)
    port = {"draft": [r["q"] for r in records],
            "p": [r["p"] for r in records],
            "big": [r["big"] for r in records]}
    out = law_numbers(served, temperature, records, refl, port)
    out.update(commit_numbers(records))
    out["records"] = len(records)
    return out, refl


def control(served, temperature: float, records: List[dict], refl: dict,
            device) -> dict:
    """The same law numbers with the float8 reference in the program's
    place."""
    low = reference_logits(served, records, device, precision="fp8")
    port = {"draft": [torch.softmax(x[:r["draft"].shape[0]] / temperature, -1)
                      for x, r in zip(low["draft"], records)],
            "p": [ref.coupled_probs(s, b, served.lam, temperature)
                  for s, b in zip(low["small"], low["big"])],
            "big": low["big"]}
    return law_numbers(served, temperature, records, refl, port)


def verdict(numbers: dict, limits: Dict[str, float]):
    """(correct, lines): each number beside its limit."""
    ok = numbers.get("records", 0) > 0
    lines = []
    for k in NUMBERS:
        v = numbers.get(k)
        lim = limits[k]
        good = v is not None and v <= lim
        ok = ok and good
        lines.append((k, v, lim, good))
    return ok, lines
