"""Speculative-decoding metrics: Block Efficiency / Decoding Speed / accuracy
(the port's own copy of `hsd_tpu/eval/metrics.py`, numpy only).

Formula parity with the reference aggregators:
  * BE = mean committed-tokens-per-target-step over steps whose draft length
    equals gamma (`compute_speculative_stats.py:78-99` — steps with a short
    draft, e.g. near max length, are excluded for fairness);
  * DS = total tokens / total wall time, with per-question time scaled by the
    fraction of tokens produced in full-gamma steps (`:99`);
  * GSM8K accuracy: last-number regex match (`eval_speculative_decoding_llm.py:
    504-523`).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np

_NUM = re.compile(r"\d*\.?\d+")


def extract_answer(text: str):
    m = _NUM.findall(text)
    return m[-1] if m else None


def test_answer(pred_str: str, gold_str: str) -> bool:
    p, g = extract_answer(pred_str), extract_answer(gold_str)
    return p is not None and g is not None and p == g


def accuracy(preds: Sequence[str], golds: Sequence[str]) -> float:
    ok = sum(test_answer(p, g) for p, g in zip(preds, golds))
    return ok / max(len(preds), 1)


def block_efficiency(accepts: Sequence[Sequence[int]],
                     draft_lens: Sequence[Sequence[int]], gamma: int) -> float:
    """accepts[q][step] = n_matches; draft_lens[q][step] = drafted tokens.

    Committed per step = n_matches + 1 (the resample/bonus token).
    """
    commit, steps = 0, 0
    for acc, dl in zip(accepts, draft_lens):
        acc = np.asarray(acc)
        dl = np.asarray(dl)
        sel = dl == gamma
        commit += (acc[sel] + 1).sum()
        steps += int(sel.sum())
    return float(commit / steps) if steps else 0.0


def decoding_speed(accepts: Sequence[Sequence[int]],
                   draft_lens: Sequence[Sequence[int]],
                   times_s: Sequence[float], gamma: int) -> float:
    """tokens/s over full-gamma steps, per the reference's time scaling."""
    total_tokens, total_time = 0.0, 0.0
    for acc, dl, t in zip(accepts, draft_lens, times_s):
        acc = np.asarray(acc, np.float64) + 1
        dl = np.asarray(dl)
        if acc.sum() <= 0:
            continue
        frac = acc[dl == gamma].sum() / acc.sum()
        total_tokens += acc[dl == gamma].sum()
        total_time += float(t) * frac
    return float(total_tokens / total_time) if total_time else 0.0


def summarize(counts: List[Dict], gamma: int) -> Dict[str, float]:
    """counts: per-question dicts with 'accepts', 'draft_lens', 'time_s'."""
    accepts = [c["accepts"] for c in counts]
    dls = [c["draft_lens"] for c in counts]
    times = [c["time_s"] for c in counts]
    return {
        "block_efficiency": block_efficiency(accepts, dls, gamma),
        "decoding_speed": decoding_speed(accepts, dls, times, gamma),
        "mean_accept": float(np.mean([a for q in accepts for a in q])) if any(accepts) else 0.0,
        "questions": len(counts),
    }


def plot_summary(summaries: Dict[str, Dict[str, float]], out_path: str,
                 title: str = "Speculative decoding") -> Optional[str]:
    """Bar chart of BE / DS per method — the reference aggregator's output
    shape (compute_speculative_stats.py bar chart, SURVEY.md §2.2 G3).

    summaries: {method_name: summarize(...) dict}. Returns the written path,
    or None when matplotlib is unavailable (headless parity is the JSONL).
    """
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    methods = list(summaries)
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.5))
    for ax, key, label in ((axes[0], "block_efficiency", "Block efficiency (tok/step)"),
                           (axes[1], "decoding_speed", "Decoding speed (tok/s)")):
        vals = [summaries[m].get(key, 0.0) for m in methods]
        ax.bar(methods, vals, color="#888888")
        ax.set_title(label)
        for i, v in enumerate(vals):
            ax.text(i, v, f"{v:.2f}", ha="center", va="bottom", fontsize=9)
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
