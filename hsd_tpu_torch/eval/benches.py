"""Multi-benchmark loaders + the reference-shaped eval driver (E7 parity;
port of `hsd_tpu/eval/benches.py`).

The counterpart of the reference's per-model eval drivers
(`EAGLE-3H/eagle/evaluation/gen_ea_answer_llama3chat.py` and siblings):

- bench routing over mt_bench / humaneval / alpaca / qa / sum / gsm8k /
  flores200 / cnndailymail (`gen_ea_answer_llama3chat.py:212-223`),
- per-bench system prompts (`:48-56`),
- humaneval "Complete the code I provided." formatting (`:155-195`),
- flores200 translation prompting (`:59-103`) and CNN/DailyMail article
  truncation + summarization prompting (`:106-154`),
- multi-turn chat (mt_bench has 2 turns) with the conversation re-rendered
  per turn and the assistant reply appended (`:412-489`),
- `num_choices` generations per question with per-choice seeding
  (`:401-402`): where the JAX driver folds `PRNGKey(seed)` with the
  question qi, the choice ci and the turn tj (warmup w: 1_000_000 + w),
  turn tj of choice ci draws from a generator seeded with
  `ops.sampling.fold_seed(seed, qi, ci, tj)` (warmup:
  `fold_seed(seed, 1_000_000 + w)`),
- the two artifacts: an answers jsonl of
  `{question_id, answer_id, model_id, choices:[{index, turns, idxs,
  new_tokens, wall_time}], tstamp}` rows and a `*_info.jsonl` of per-choice
  stage-timing rows (`:517-533`), consumed by `eval.eagle_metrics`,
- `reorg_answer_file` sort+dedup (`:535-545`).

Where the reference fans questions out with Ray (`:233-263`), here any
process launcher works: pass `shard="i/n"` to each process (SPMD-friendly).
Network dataset pulls (`datasets.load_dataset` for flores200 / HF gsm8k)
are replaced by local jsonl paths: file inputs keep evals hermetic.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import uuid
from typing import Callable, Dict, List, Optional

import numpy as np

from ..models.transformer import resolve_device
from ..ops.sampling import fold_generator
from ..utils.profiling import synchronize
from .eagle_metrics import alpha_from_blocks
from .gsm8k import bucket_pad, prompt_tensor

# ---------------------------------------------------------------------------
# System prompts (gen_ea_answer_llama3chat.py:48-56)
# ---------------------------------------------------------------------------

_DEFAULT_SYSTEM = (
    "You are a helpful, respectful and honest assistant. Always answer as "
    "helpfully as possible, while being safe. Your answers should not "
    "include any harmful, unethical, racist, sexist, toxic, dangerous, or "
    "illegal content. Please ensure that your responses are socially "
    "unbiased and positive in nature.\n\nIf a question does not make any "
    "sense, or is not factually coherent, explain why instead of answering "
    "something not correct. If you don't know the answer to a question, "
    "please don't share false information.")

SYSTEM_PROMPTS: Dict[str, str] = {
    "flores200": ("You are a helpful translation assistant. Provide "
                  "accurate and natural translations."),
    "cnndailymail": ("You are a helpful assistant skilled at summarizing "
                     "news articles. Provide concise and accurate "
                     "summaries."),
}


def get_system_prompt(bench_name: str) -> str:
    return SYSTEM_PROMPTS.get(bench_name, _DEFAULT_SYSTEM)


# ---------------------------------------------------------------------------
# Question loaders — all return the fastchat row shape:
#   {"question_id", "category", "turns": [...], "reference": [...]}
# ---------------------------------------------------------------------------

def _read_jsonl(path: str) -> List[dict]:
    with open(path, encoding="utf-8") as f:
        return [json.loads(l) for l in f if l.strip()]


def _slice(rows: List[dict], begin: Optional[int], end: Optional[int]
           ) -> List[dict]:
    return rows[begin or 0: end if end is not None else len(rows)]


def load_question_jsonl(path: str, begin: Optional[int] = None,
                        end: Optional[int] = None) -> List[dict]:
    """fastchat `load_questions` parity: plain jsonl slice — covers
    mt_bench / alpaca / qa / sum question.jsonl files."""
    return _slice(_read_jsonl(path), begin, end)


def load_humaneval_questions(path: str, begin: Optional[int] = None,
                             end: Optional[int] = None) -> List[dict]:
    """HumanEval rows {task_id, prompt, canonical_solution} → code-completion
    instructions (gen_ea_answer_llama3chat.py:155-195)."""
    out = []
    for idx, item in enumerate(_read_jsonl(path)):
        out.append({
            "question_id": idx,
            "category": "code",
            "turns": [f"Complete the code I provided.\n{item['prompt']}"],
            "task_id": item.get("task_id", f"HumanEval/{idx}"),
            "reference": [item.get("canonical_solution", "")],
        })
    return _slice(out, begin, end)


def load_cnndailymail_questions(path: str, begin: Optional[int] = None,
                                end: Optional[int] = None,
                                max_article_chars: int = 6000) -> List[dict]:
    """CNN/DailyMail test.jsonl rows {article, highlights} → summarization
    prompts, articles truncated to bound the KV footprint
    (gen_ea_answer_llama3chat.py:106-154; ~4 chars/token heuristic)."""
    out = []
    for idx, item in enumerate(_read_jsonl(path)):
        article = item["article"]
        if len(article) > max_article_chars:
            article = article[:max_article_chars] + "..."
        out.append({
            "question_id": idx,
            "category": "summarization",
            "turns": [("Please summarize the following news article in a "
                       f"few sentences:\n\n{article}")],
            "reference": [item.get("highlights", "")],
        })
    return _slice(out, begin, end)


def load_flores200_questions(path: str, begin: Optional[int] = None,
                             end: Optional[int] = None,
                             source_lang: str = "eng_Latn",
                             target_lang: str = "fra_Latn") -> List[dict]:
    """flores200 translation pairs from a local jsonl with
    {source, target, source_lang, target_lang} rows (the reference pulls
    bri25yu/flores200_devtest_translation_pairs over the network,
    gen_ea_answer_llama3chat.py:59-103; rows without lang fields are taken
    as already filtered)."""
    out = []
    src_name = source_lang.split("_")[0].capitalize()
    tgt_name = target_lang.split("_")[0].capitalize()
    idx = 0
    for item in _read_jsonl(path):
        if "source_lang" in item and (item["source_lang"] != source_lang or
                                      item.get("target_lang") != target_lang):
            continue
        out.append({
            "question_id": idx,
            "category": "translation",
            "turns": [(f"Translate the following {src_name} text to "
                       f"{tgt_name}. Only provide the translation without "
                       "any explanation or additional text:\n\n"
                       f"{item['source']}")],
            "reference": [item.get("target", "")],
        })
        idx += 1
    return _slice(out, begin, end)


def load_gsm8k_questions(path: str, begin: Optional[int] = None,
                         end: Optional[int] = None) -> List[dict]:
    """GSM8K test rows {question, answer} → single-turn questions with the
    gold answer as reference (performance_evaluation.py:63-80)."""
    out = [{"question_id": idx, "category": "math",
            "turns": [item["question"]], "reference": [item["answer"]]}
           for idx, item in enumerate(_read_jsonl(path))]
    return _slice(out, begin, end)


_LOADERS: Dict[str, Callable] = {
    "humaneval": load_humaneval_questions,
    "cnndailymail": load_cnndailymail_questions,
    "flores200": load_flores200_questions,
    "gsm8k": load_gsm8k_questions,
}


def load_bench_questions(bench_name: str, question_file: str,
                         begin: Optional[int] = None,
                         end: Optional[int] = None,
                         shard: Optional[str] = None,
                         **kw) -> List[dict]:
    """Bench-name routing (gen_ea_answer_llama3chat.py:212-223) + optional
    `i/n` sharding in place of the reference's Ray chunking (:233-263)."""
    loader = _LOADERS.get(bench_name, load_question_jsonl)
    rows = loader(question_file, begin, end, **kw)
    if shard:
        i, n = map(int, shard.split("/"))
        rows = rows[i::n]
    return rows


# ---------------------------------------------------------------------------
# Chat templates — multi-turn rendering with a system prompt. The reference
# defers to HF `tokenizer.apply_chat_template`; here the two template
# families its models use are rendered directly so evals run with any
# tokenizer (including the byte fallback).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChatTemplate:
    """messages = [{"role": "system"|"user"|"assistant", "content": str}]
    → prompt string with the assistant turn left open."""
    style: str = "qwen"  # qwen | llama3 | plain

    def render(self, messages: List[dict]) -> str:
        if self.style == "qwen":
            s = "".join(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n"
                        for m in messages)
            return s + "<|im_start|>assistant\n"
        if self.style == "llama3":
            s = "<|begin_of_text|>" + "".join(
                f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
                f"{m['content']}<|eot_id|>" for m in messages)
            return s + "<|start_header_id|>assistant<|end_header_id|>\n\n"
        return "\n".join(m["content"] for m in messages) + "\n"

    @property
    def stop_strings(self) -> List[str]:
        if self.style == "qwen":
            return ["<|im_end|>", "<|endoftext|>"]
        if self.style == "llama3":
            return ["<|eot_id|>", "<|end_of_text|>"]
        return []


def strip_output(text: str, template: ChatTemplate) -> str:
    """Cut at the first stop string and drop stray special tokens — the
    decode-side twin of the reference's stop_token_ids truncation + special
    token scrubbing (gen_ea_answer_llama3chat.py:449-478)."""
    for s in template.stop_strings:
        pos = text.find(s)
        if pos >= 0:
            text = text[:pos]
    for s in template.stop_strings + ["<|im_start|>", "<|begin_of_text|>",
                                      "<|start_header_id|>",
                                      "<|end_header_id|>"]:
        text = text.replace(s, "")
    return text.strip()


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def run_multibench(questions: List[dict], tokenizer, generate: Callable,
                   out_dir: str, tag: str, *, bench_name: str = "mt_bench",
                   model_id: str = "hsd_tpu", num_choices: int = 1,
                   warmup: int = 3, seed: int = 0,
                   template: Optional[ChatTemplate] = None,
                   max_turns: Optional[int] = None, device=None) -> dict:
    """Reference-shaped multi-bench eval loop.

    generate(prompt_ids [P] int64 tensor, prompt_len, generator) ->
    GenerateResult-like with .tokens/.length/.blocks/.accepts/.draft_lens
    (both the speculative and the EAGLE engines qualify); the prompts go to
    `device` (the card unless given). Writes `{tag}.jsonl` answers and
    `{tag}_info.jsonl` telemetry (gen_ea_answer_llama3chat.py:517-533).
    """
    dev = resolve_device(device)
    template = template or ChatTemplate()
    os.makedirs(out_dir, exist_ok=True)
    ans_path = os.path.join(out_dir, f"{tag}.jsonl")
    info_path = os.path.join(out_dir, f"{tag}_info.jsonl")
    system = get_system_prompt(bench_name)

    def one_turn(messages: List[dict], generator) -> tuple:
        t0 = time.perf_counter()
        prompt = template.render(messages)
        ids = tokenizer.encode(prompt)
        padded, n = bucket_pad(ids)
        tok_t = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = generate(prompt_tensor(padded, dev), n, generator)
        synchronize(res.tokens)
        gen_t = time.perf_counter() - t0
        t0 = time.perf_counter()
        out_ids = res.tokens[len(padded):int(res.length)].tolist()
        text = strip_output(tokenizer.decode(out_ids), template)
        dec_t = time.perf_counter() - t0
        nb = int(res.blocks)
        pl = getattr(res, "path_lens", None)
        pl = pl[:nb].tolist() if pl is not None and pl.dim() else None
        return (text, int(res.ncommit), nb, gen_t, tok_t, dec_t,
                res.accepts[:nb].tolist(), res.draft_lens[:nb].tolist(), pl)

    # Warmup: first question, untimed (ref runs it 3x, :311-389).
    if questions and warmup:
        msgs = [{"role": "system", "content": system},
                {"role": "user", "content": questions[0]["turns"][0]}]
        for w in range(warmup):
            one_turn(msgs, fold_generator(seed, 1_000_000 + w, device=dev))

    total_tokens, total_time = 0, 0.0
    with open(ans_path, "w") as fa, open(info_path, "w") as fi:
        for qi, q in enumerate(questions):
            turns_all = q["turns"][:max_turns] if max_turns else q["turns"]
            choices, infos = [], []
            for ci in range(num_choices):
                messages = [{"role": "system", "content": system}]
                turns, idxs, new_tokens, wall = [], [], [], []
                info = {k: [] for k in
                        ("tokenizer_time", "tokenizer_decode_time",
                         "generate_time", "accept_length", "draft_length")}
                alpha = np.zeros((5,), np.int64)
                alpha_num = np.zeros((5,), np.int64)
                have_alpha = False
                for tj, user_text in enumerate(turns_all):
                    messages.append({"role": "user", "content": user_text})
                    (text, ncommit, nb, gen_t, tok_t, dec_t, acc,
                     dl, pl) = one_turn(messages, fold_generator(
                         seed, qi, ci, tj, device=dev))
                    if pl is not None:
                        # per-position acceptance counts (the paper's alpha;
                        # aggregator parity with evaluation/alpha.py:16-30)
                        a_t, n_t = alpha_from_blocks(acc, pl)
                        alpha += a_t
                        alpha_num += n_t
                        have_alpha = True
                    messages.append({"role": "assistant", "content": text})
                    turns.append(text)
                    idxs.append(nb)
                    new_tokens.append(ncommit)
                    wall.append(gen_t)
                    info["tokenizer_time"].append(tok_t)
                    info["tokenizer_decode_time"].append(dec_t)
                    info["generate_time"].append(gen_t)
                    info["accept_length"].append(acc)
                    info["draft_length"].append(dl)
                    total_tokens += ncommit
                    total_time += gen_t
                choice = {"index": ci, "turns": turns, "idxs": idxs,
                          "new_tokens": new_tokens, "wall_time": wall}
                if have_alpha:
                    choice["alpha"] = alpha.tolist()
                    choice["alpha_num"] = alpha_num.tolist()
                    info["alpha"] = [alpha.tolist()]
                    info["alpha_num"] = [alpha_num.tolist()]
                choices.append(choice)
                infos.append(info)
            fa.write(json.dumps({
                "question_id": q["question_id"],
                "answer_id": uuid.uuid4().hex[:22],
                "model_id": model_id,
                "choices": choices,
                "tstamp": time.time(),
            }) + "\n")
            for info in infos:
                fi.write(json.dumps(info) + "\n")
    return {"answers": ans_path, "info": info_path,
            "questions": len(questions), "new_tokens": total_tokens,
            "total_time_s": total_time,
            "tokens_per_s": total_tokens / total_time if total_time else 0.0}


def reorg_answer_file(answer_file: str) -> None:
    """Sort by question id and de-duplicate, keeping the last answer per id
    (gen_ea_answer_llama3chat.py:535-545) — needed after sharded runs append
    to a shared file."""
    answers: Dict = {}
    with open(answer_file) as f:
        for line in f:
            if line.strip():
                answers[json.loads(line)["question_id"]] = line
    with open(answer_file, "w") as f:
        for qid in sorted(answers):
            f.write(answers[qid])
