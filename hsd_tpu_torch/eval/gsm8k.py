"""GSM8K chain-of-thought evaluation harness (port of
`hsd_tpu/eval/gsm8k.py`).

The counterpart of the reference's
`chain-of-thought-hub/gsm8k/eval_speculative_decoding_llm.py` (727 lines of
argparse + HF generate): loads the GSM8K test split, builds the CoT prompt
with the Qwen chat template, drives the speculative engine per question, and
writes the same artifact shapes — an answers file in `Q:/A_model:/A:` format
(consumed by metrics.accuracy) and a per-question counts JSON for BE/DS.

Data inputs are paths (no network): a GSM8K jsonl with {"question","answer"}
rows and a CoT few-shot prompt text file (the reference reads
`lib_prompt/prompt_original.txt`; `default_prompt_path` resolves the port's
own copy). Tokenization uses an HF tokenizer when given, else a byte
fallback.

Randomness: where the JAX harness folds `PRNGKey(seed)` with the question
index, question qi here draws from `question_generator(seed, qi)`, a
torch.Generator seeded with `ops.sampling.fold_seed(seed, qi)`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import EngineConfig, ModelConfig
from ..engine import make_generate
from ..models.transformer import resolve_device
from ..ops.sampling import fold_generator
from ..utils.profiling import synchronize
from .metrics import accuracy, summarize

LIB_PROMPT = os.path.join(os.path.dirname(__file__), "lib_prompt")


def load_gsm8k_jsonl(path: str, limit: Optional[int] = None,
                     stride: int = 5) -> List[dict]:
    """Reference uses every 5th test question (1319//5=263 rows,
    eval_speculative_decoding_llm.py:100)."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.strip():
                rows.append(json.loads(line))
    rows = rows[::stride]
    return rows[:limit] if limit else rows


def qwen_chat_wrap(user_text: str) -> str:
    """Qwen2.5 chat template (system + user turn, assistant open)."""
    return ("<|im_start|>system\nYou are Qwen, created by Alibaba Cloud. "
            "You are a helpful assistant.<|im_end|>\n"
            f"<|im_start|>user\n{user_text}<|im_end|>\n"
            "<|im_start|>assistant\n")


def default_prompt_path(name: str = "original") -> str:
    """The port's packaged few-shot CoT prompt library (`lib_prompt/`,
    written by eval/prompt_library.py; byte-equal to the JAX package's):
    the same `Question:/Let's think step by step/The answer is N` shape and
    the reference's 27 variant file names. `name` is a variant stem, e.g.
    "original", "hardest" (the reference harness's own default,
    eval_speculative_decoding_llm.py:378), "easy", "semicolon",
    "8x8step"..."""
    path = os.path.join(LIB_PROMPT, f"prompt_{name}.txt")
    if not os.path.exists(path):
        import glob as _g
        have = sorted(os.path.basename(p)[len("prompt_"):-4] for p in _g.glob(
            os.path.join(LIB_PROMPT, "prompt_*.txt")))
        raise FileNotFoundError(f"no prompt variant {name!r}; have {have}")
    return path


def build_prompt(question: str, shots_text: str) -> str:
    """CoT prompt: few-shot examples then the question (ref :375-378)."""
    return qwen_chat_wrap(
        f"{shots_text}\nQuestion: {question}\nLet's think step by step\n")


def bucket_pad(ids: List[int], buckets=(512, 1024, 1536, 2048)):
    """LEFT-pad token ids into the smallest fitting static bucket. Past the
    largest bucket: the last 2048 ids, and n = 2048 (the reference's)."""
    n = len(ids)
    for b in buckets:
        if n <= b:
            return np.asarray([0] * (b - n) + ids, np.int32), n
    return np.asarray(ids[-buckets[-1]:], np.int32), buckets[-1]


def prompt_tensor(padded: np.ndarray, device) -> torch.Tensor:
    """bucket_pad's ids as the engines' [P] int64 prompt on `device`."""
    return torch.from_numpy(padded.astype(np.int64)).to(device)


def question_generator(seed: int, qi: int, device) -> torch.Generator:
    """The generator run_eval gives question qi (JAX: fold_in(key, qi))."""
    return fold_generator(seed, qi, device=device)


@dataclasses.dataclass
class EvalConfig:
    engine: EngineConfig
    out_dir: str = "gsm8k_out"
    tag: str = "run"
    seed: int = 0


def run_eval(cfg_draft: ModelConfig, cfg_target: ModelConfig, params_draft,
             params_target, tokenizer, questions: List[dict],
             shots_text: str, ev: EvalConfig, target_forward=None,
             target_cache_ops=None, device=None) -> dict:
    """Evaluate; returns summary metrics and writes artifacts.

    tokenizer: object with .encode(str)->List[int] and .decode(List[int])->str
    (an HF tokenizer works as-is).
    target_forward / target_cache_ops: make_generate's target override
    (e.g. eval.synthetic.make_coupled_target).
    device: where the prompts go (the parameters' device); the card unless
    given, raising without one.
    """
    dev = resolve_device(device)
    os.makedirs(ev.out_dir, exist_ok=True)
    counts, answers = [], []
    gamma = ev.engine.verifier.gamma
    gen = make_generate(cfg_draft, cfg_target, ev.engine,
                        target_forward=target_forward,
                        target_cache_ops=target_cache_ops)

    for qi, row in enumerate(questions):
        prompt_text = build_prompt(row["question"], shots_text)
        ids = tokenizer.encode(prompt_text)
        padded, n = bucket_pad(ids)
        bucket = padded.shape[0]
        prompt = prompt_tensor(padded, dev)
        t0 = time.perf_counter()
        res = gen(params_draft, params_target, prompt, n,
                  question_generator(ev.seed, qi, dev))
        synchronize(res.tokens)
        dt = time.perf_counter() - t0
        # the one transfer of the question's tokens to the host
        out_ids = res.tokens[bucket:res.length].tolist()
        text = tokenizer.decode(out_ids)
        nblocks = int(res.blocks)
        accepts_l = res.accepts[:nblocks].tolist()
        dlens_l = res.draft_lens[:nblocks].tolist()
        counts.append({
            "accepts": accepts_l,
            "draft_lens": dlens_l,
            "time_s": dt,
            "new_tokens": int(res.ncommit),
            # reference-named aliases (nested one generation call deep) so
            # the reference's compute_speculative_stats.py consumes this
            # artifact directly (ref keys at utils.py:4644-4647; consumption
            # at compute_speculative_stats.py:78-99): draft_eval = drafted
            # tokens per step (utils.py:4749 `draft_eval += candidate_length`),
            # sample_length = committed per step (accepted + 1), target_eval
            # = TARGET FORWARD CALLS per step (utils.py:4750
            # `target_eval += 1` each speculation round — NOT committed
            # tokens), total_step = rounds (1 per block in clever mode).
            "draft_eval": [dlens_l],
            "sample_length": [[a + 1 for a in accepts_l]],
            "target_eval": [[1] * nblocks],
            "total_step": [[1] * nblocks],
            "time": [dt],
            # ref counts channel also carries the committed ids and, in the
            # recursive/forward-sampling modes, per-block inner-round counts
            # (hist_lengths; single-pass engines return rounds=None and
            # the key is omitted, as the JAX harness omits its 0-d default)
            "ids": [out_ids],
            **({"hist_lengths": [res.rounds[:nblocks].tolist()]}
               if getattr(res, "rounds", None) is not None else {}),
        })
        answers.append((row["question"], text, row["answer"]))

    # artifacts in the reference's shapes
    ans_path = os.path.join(ev.out_dir, f"answers_{ev.tag}.txt")
    with open(ans_path, "w") as f:
        for q, am, a in answers:
            f.write(f"Q: {q}\nA_model:\n{am}\nA:\n{a}\n\n")
    counts_path = os.path.join(ev.out_dir, f"counts_{ev.tag}.json")
    with open(counts_path, "w") as f:
        json.dump(counts, f)

    summary = summarize(counts, gamma)
    v = ev.engine.verifier
    striped = (not v.parallel) and v.num_drafts > 1
    summary["config"] = {
        "method": v.method, "gamma": v.gamma, "num_drafts": v.num_drafts,
        "striped": striped,
        # striped rows under the capped default ('hsd') run the
        # exactness-restoring prefix gate; 'hsd_ref' striped reproduces the
        # reference's ungated behavior — their BE numbers are not
        # comparable, so every stats row says which gate semantics
        # produced it
        "gated": bool(striped and v.method == "hsd"),
    }
    summary["accuracy"] = accuracy([a[1] for a in answers],
                                   [a[2] for a in answers])
    summary["artifacts"] = {"answers": ans_path, "counts": counts_path}
    summary["model_answers"] = [a[1] for a in answers]
    return summary


class ByteTokenizer:
    """Fallback tokenizer for runs without an HF tokenizer. decode takes
    each id % 256, so a wide vocabulary's ids decode as bytes."""

    vocab_size = 256

    def encode(self, s: str) -> List[int]:
        return list(s.encode("utf-8", errors="ignore"))

    def decode(self, ids: List[int]) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="ignore")
