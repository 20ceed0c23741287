"""Generic benchmark runner over question.jsonl files (port of
`hsd_tpu/eval/bench_runner.py`).

Covers the reference's multi-bench eval drivers
(`EAGLE-3H/eagle/evaluation/gen_ea_answer_llama3chat.py` and
`performance_evaluation.py:63-154`): mt_bench / humaneval / alpaca / qa / sum
ship as `question.jsonl` rows with {"question_id", "turns": [...]} (first
turn used); gsm8k rows use {"question", "answer"}; translation/summarization
rows carry their own text fields. One runner handles them via a field mapper,
drives any engine (speculative or EAGLE), and writes the reference's two
artifacts: answers jsonl and `_info.jsonl` (consumed by eval/eagle_metrics).

Randomness: where the JAX runner folds `PRNGKey(seed)` with 10_000 + w
(warmup w) and with the question index qi, the port passes generators
seeded with `ops.sampling.fold_seed(seed, 10_000 + w)` and
`fold_seed(seed, qi)`.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, List, Optional

from ..models.transformer import resolve_device
from ..ops.sampling import fold_generator
from ..utils.profiling import synchronize
from .eagle_metrics import write_info_row
from .gsm8k import bucket_pad, prompt_tensor


def extract_question(row: dict) -> str:
    if "turns" in row:
        return row["turns"][0]
    if "question" in row:
        return row["question"]
    if "instruction" in row:
        return row["instruction"]
    for k in ("text", "article", "prompt"):
        if k in row:
            return row[k]
    raise KeyError(f"no question field in row keys={list(row)}")


def load_questions(path: str, limit: Optional[int] = None,
                   shard: Optional[str] = None) -> List[dict]:
    with open(path) as f:
        rows = [json.loads(l) for l in f if l.strip()]
    if shard:
        i, n = map(int, shard.split("/"))
        rows = rows[i::n]
    return rows[:limit] if limit else rows


def run_bench(questions: List[dict], tokenizer, prompt_wrap: Callable[[str], str],
              generate: Callable, out_dir: str, tag: str,
              warmup: int = 1, seed: int = 0, device=None) -> dict:
    """generate(prompt_ids [P] int64 tensor, prompt_len, generator) ->
    object with .tokens/.length/.accepts/.draft_lens/.blocks
    (GenerateResult-like); the prompts go to `device` (the card unless
    given).

    Writes `{tag}.jsonl` (answers) and `{tag}_info.jsonl` (per-question
    stage/accept telemetry in the reference's shape,
    gen_ea_answer_llama3chat.py:489-533). Warmup runs the first question
    `warmup` extra times untimed (ref does 3, :311-389)."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    ans_path = os.path.join(out_dir, f"{tag}.jsonl")
    info_path = os.path.join(out_dir, f"{tag}_info.jsonl")
    total_time = 0.0
    with open(ans_path, "w") as fa, open(info_path, "w") as fi:
        for qi, row in enumerate(questions):
            text = prompt_wrap(extract_question(row))
            ids = tokenizer.encode(text)
            padded, n = bucket_pad(ids)
            prompt = prompt_tensor(padded, dev)
            if qi == 0:
                for w in range(warmup):
                    r = generate(prompt, n,
                                 fold_generator(seed, 10_000 + w, device=dev))
                    synchronize(r.tokens)
            t0 = time.perf_counter()
            res = generate(prompt, n, fold_generator(seed, qi, device=dev))
            synchronize(res.tokens)
            dt = time.perf_counter() - t0
            total_time += dt
            out_ids = res.tokens[len(padded):int(res.length)].tolist()
            answer = tokenizer.decode(out_ids)
            nb = int(res.blocks)
            fa.write(json.dumps({
                "question_id": row.get("question_id", qi),
                "answer": answer,
                "new_tokens": int(res.ncommit) if hasattr(res, "ncommit")
                else len(out_ids),
            }) + "\n")
            write_info_row(fi, res.accepts[:nb].tolist(),
                           res.draft_lens[:nb].tolist(), dt)
    return {"answers": ans_path, "info": info_path,
            "questions": len(questions), "total_time_s": total_time}
