"""EAGLE-bench metrics from `*_info.jsonl` artifacts (the port's own copy of
`hsd_tpu/eval/eagle_metrics.py`, numpy only).

Formula parity with `EAGLE-3H/performance_evaluation.py:122-187`:
  BE = sum(accept_length | draft_length == gamma) / count(draft == gamma)
  DS = count(draft == gamma) / total generate_time * gamma
The reference ships real per-question result files under
`EAGLE-3H/results/{h100,h200}_{eagle,HSD}/` which serve as regression
fixtures for this module (tests/test_eval_fixtures.py).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np


def _flatten(x):
    if x and isinstance(x, list) and isinstance(x[0], list):
        return x[0]
    return x


def evaluate_info_rows(rows: Iterable[dict], gamma: int = 7
                       ) -> Dict[str, float]:
    sample = cnt = 0
    total_time = 0.0
    nrows = 0
    for d in rows:
        da = np.asarray(_flatten(d.get("draft_length", [[]])))
        aa = np.asarray(_flatten(d.get("accept_length", [[]])))
        gt = d.get("generate_time", [0.0])
        gt = gt[0] if isinstance(gt, list) else gt
        sample += aa[da == gamma].sum()
        cnt += int((da == gamma).sum())
        total_time += float(gt)
        nrows += 1
    be = sample / cnt if cnt else 0.0
    ds = cnt / total_time * gamma if total_time > 0 else 0.0
    return {"block_efficiency": float(be), "decoding_speed": float(ds),
            "avg_time": total_time / nrows if nrows else 0.0,
            "questions": nrows}


def evaluate_info_file(path: str, gamma: int = 7) -> Optional[Dict[str, float]]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rows = [json.loads(l) for l in f if l.strip()]
    return evaluate_info_rows(rows, gamma)


def write_info_row(fh, accepts, draft_lens, generate_time: float,
                   stage_times: Optional[Dict[str, list]] = None,
                   path_lens=None, max_alpha_pos: int = 5):
    """Emit one `_info.jsonl` row in the reference's shape
    (gen_ea_answer_llama3chat.py:489-533) from engine telemetry.

    With `path_lens` (EagleGenerateResult.path_lens) the row additionally
    carries the paper's per-position acceptance counts `alpha`/`alpha_num`
    in the shape the reference's aggregator consumes
    (evaluation/alpha.py:16-30: per-question lists summed over questions)."""
    row = {
        "accept_length": [list(map(int, accepts))],
        "draft_length": [list(map(int, draft_lens))],
        "generate_time": [float(generate_time)],
    }
    if path_lens is not None:
        a, n = alpha_from_blocks(accepts, path_lens, max_alpha_pos)
        row["alpha"] = [a.tolist()]
        row["alpha_num"] = [n.tolist()]
    if stage_times:
        row.update(stage_times)
    fh.write(json.dumps(row) + "\n")


def alpha_from_blocks(accepts, path_lens, max_pos: int = 5):
    """Per-position acceptance COUNTS from per-block engine telemetry.

    The paper's alpha_i = P(position i of the best path accepted | position i
    was tested). A block with accept_length = a over a best path of valid
    length `plen` (root included, so plen - 1 drafted positions) tested
    positions 0..min(a, plen-2) and accepted positions 0..a-1
    (ref: the gen_ea_alpha_* drivers accumulate alpha/alpha_num inside
    evaluate_posterior; the module that did so, model/utils_alpha.py, is
    absent from the reference tree — re-derived here from the alpha
    definition in the EAGLE paper and the aggregator, evaluation/alpha.py).

    Returns (alpha [max_pos], alpha_num [max_pos]) int arrays: per-position
    accepted / tested counts summed over blocks.
    """
    acc = np.asarray(accepts)
    pl = np.asarray(path_lens)
    alpha = np.zeros((max_pos,), np.int64)
    num = np.zeros((max_pos,), np.int64)
    for a, plen in zip(acc, pl):
        if a < 0 or plen <= 0:
            continue
        drafted = max(int(plen) - 1, 0)
        tested = min(int(a) + 1, drafted)       # rejection tests one extra
        for i in range(min(tested, max_pos)):
            num[i] += 1
            if i < a:
                alpha[i] += 1
    return alpha, num


def evaluate_alpha_rows(rows: Iterable[dict], max_pos: int = 5) -> np.ndarray:
    """The reference's alpha aggregator (evaluation/alpha.py:16-30): sum the
    per-question `alpha`/`alpha_num` lists and return their ratio."""
    alphas = np.zeros((max_pos,), np.float64)
    nums = np.zeros((max_pos,), np.float64)
    for d in rows:
        ch = d.get("choices", [d])[0] if "choices" in d else d
        a = np.asarray(_flatten(ch.get("alpha", [])), np.float64)
        n = np.asarray(_flatten(ch.get("alpha_num", [])), np.float64)
        k = min(len(a), max_pos)
        alphas[:k] += a[:k]
        nums[:k] += n[:k]
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(nums > 0, alphas / nums, 0.0)


def speed_from_rows(rows: Iterable[dict], token_field: str = "new_tokens"
                    ) -> float:
    """Mean per-question decoding speed (tokens / wall_time) — the
    reference's speed.py:17-24 numerator (it re-tokenizes baseline rows only
    because those lack `new_tokens`; ours always carry them)."""
    speeds = []
    for d in rows:
        ch = d.get("choices", [d])[0] if "choices" in d else d
        toks = ch.get(token_field, ch.get("new_tokens", 0))
        toks = sum(toks) if isinstance(toks, list) else toks
        wt = ch.get("wall_time", ch.get("generate_time", 0.0))
        wt = sum(wt) if isinstance(wt, list) else wt
        if wt:
            speeds.append(toks / wt)
    return float(np.mean(speeds)) if speeds else 0.0


def speed_ratio(rows_method: Iterable[dict], rows_baseline: Iterable[dict]
                ) -> Dict[str, float]:
    """The reference's post-hoc speed-ratio aggregator (speed.py:70-77):
    mean speed of the method over mean speed of the AR baseline."""
    s = speed_from_rows(rows_method)
    s0 = speed_from_rows(rows_baseline)
    return {"speed": s, "speed_baseline": s0,
            "ratio": s / s0 if s0 else 0.0}
