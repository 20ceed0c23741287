"""Training data pipeline: conversations -> (input_ids, loss_mask) batches;
port of `hsd_tpu/train/data.py`.

The counterpart of the reference's conversation->tensors side:

  * `build_dataset_rank` — ShareGPT jsonl -> chat-template token ids with
    per-role loss masks (EAGLE-3H/eagle/traineagle3/main.py:54-200);
  * `CustomDataset` — precomputed-feature rows with the EAGLE-1 shift
    contract (EAGLE-3H/eagle/train/main.py:133-172);
  * `DataCollatorWithPadding` — padding collation (train/main.py:175-205);
  * `AddGaussianNoise` / `AddUniformNoise` hidden-state augmentation
    (train/main.py:108-130);
  * `list_files` shard discovery (train/main.py:100-106).

Everything but the noise is numpy and gives the JAX package's batches bit
for bit from the same `default_rng(seed)`: the same shuffle, masks,
buckets and padding.

  * **Structural loss masks, not string-split offsets.** Each message
    renders to its own template segment and the segments are tokenized
    independently and concatenated, so the assistant-content token span is
    known exactly by construction (the reference splits the rendered
    conversation and re-tokenizes with hand-tuned offsets).
  * **Fixed bucket padding, not max-in-batch.** Sequences right-pad to the
    smallest of a static bucket ladder; batches group by bucket, so a
    trainer sees len(buckets) shapes.
  * The noise functions draw from a `torch.Generator` where the JAX
    package threads a key: the same law, not the same bits.

The output contract is what the trainers consume unchanged:
`train_loop(..., data_epochs=conversation_data_epochs(...))` yields
`(input_ids [B, T], loss_mask [B, T])` numpy batches for both
`train/eagle1.make_eagle1_train_step` and `train/eagle3.make_train_step`.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

# the reference's training system prompt (traineagle3/main.py:72-74) is the
# same default the eval side uses — reuse one definition
from ..eval.benches import ChatTemplate, _DEFAULT_SYSTEM

DEFAULT_BUCKETS = (256, 512, 1024, 2048)


# ---------------------------------------------------------------------------
# shard discovery (ref list_files, train/main.py:100-106)
# ---------------------------------------------------------------------------

def list_data_files(path: str, suffix: Optional[str] = None) -> List[str]:
    """Recursive file walk, sorted for determinism; optional suffix filter.
    Shard with `files[i::n]` per process (the reference shards the same list
    by slicing across data-parallel ranks)."""
    out = []
    for root, _dirs, files in os.walk(path):
        for f in files:
            if suffix is None or f.endswith(suffix):
                out.append(os.path.join(root, f))
    return sorted(out)


# ---------------------------------------------------------------------------
# ShareGPT conversations -> messages
# ---------------------------------------------------------------------------

def load_sharegpt(path: str, system: str = _DEFAULT_SYSTEM) -> List[List[dict]]:
    """ShareGPT-style jsonl/json rows
    `{"id": ..., "conversations": [{"from": "human"|"gpt", "value": ...}]}`
    -> message lists `[{"role", "content"}, ...]` with the system prompt
    prepended (ref build_dataset_rank, traineagle3/main.py:66-92: drop a
    leading non-human turn, enforce strict user/assistant alternation —
    rows violating it are skipped rather than asserted)."""
    with open(path, encoding="utf-8") as f:
        head = f.read(1)
        f.seek(0)
        rows = json.load(f) if head == "[" else \
            [json.loads(l) for l in f if l.strip()]
    roles = {"human": "user", "gpt": "assistant",
             "user": "user", "assistant": "assistant"}
    out = []
    for row in rows:
        source = row.get("conversations") or []
        if source and roles.get(source[0].get("from")) != "user":
            source = source[1:]
        if not source:
            continue
        msgs = [{"role": "system", "content": system}]
        ok = True
        for j, turn in enumerate(source):
            role = roles.get(turn.get("from"))
            if role != ("user", "assistant")[j % 2]:
                ok = False
                break
            msgs.append({"role": role, "content": turn.get("value") or ""})
        if ok and len(msgs) >= 3:      # at least one user+assistant pair
            out.append(msgs)
    return out


# ---------------------------------------------------------------------------
# structural tokenization with per-role loss masks
# ---------------------------------------------------------------------------

def _segments(template: ChatTemplate, messages: List[dict]
              ) -> List[Tuple[str, int]]:
    """Render `messages` as (text, loss) segments whose concatenation equals
    `template.render(messages)` minus the trailing open assistant header.
    loss=1 exactly on assistant content + its closing token (the span the
    reference trains on after masking instructions)."""
    segs: List[Tuple[str, int]] = []
    if template.style == "qwen":
        for m in messages:
            if m["role"] == "assistant":
                segs.append((f"<|im_start|>{m['role']}\n", 0))
                segs.append((f"{m['content']}<|im_end|>", 1))
                segs.append(("\n", 0))
            else:
                segs.append(
                    (f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n", 0))
        return segs
    if template.style == "llama3":
        segs.append(("<|begin_of_text|>", 0))
        for m in messages:
            if m["role"] == "assistant":
                segs.append(
                    (f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n", 0))
                segs.append((f"{m['content']}<|eot_id|>", 1))
            else:
                segs.append(
                    (f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
                     f"{m['content']}<|eot_id|>", 0))
        return segs
    # plain: newline-joined contents, assistant lines carry loss
    for i, m in enumerate(messages):
        segs.append((m["content"] + "\n", 1 if m["role"] == "assistant" else 0))
    return segs


def tokenize_conversation(tokenizer, messages: List[dict],
                          template: Optional[ChatTemplate] = None,
                          max_len: int = 2048
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """messages -> (input_ids [T], loss_mask [T]) with loss=1 exactly on
    assistant-content tokens (incl. the closing end-token), truncated to
    max_len. Replaces the reference's split/offset heuristics
    (traineagle3/main.py:105-151) with exact per-segment spans."""
    template = template or ChatTemplate()
    ids: List[int] = []
    mask: List[int] = []
    for text, loss in _segments(template, messages):
        # per-segment encoding must NOT insert special tokens: HF tokenizers
        # that auto-add BOS (Llama-3) would prepend <|begin_of_text|> to
        # EVERY segment, corrupting input_ids and marking injected BOS
        # tokens loss=1 inside assistant spans — the templates above already
        # emit the specials as literal text where they belong.
        try:
            seg = tokenizer.encode(text, add_special_tokens=False)
        except TypeError:          # tokenizers without the kwarg (ByteTokenizer)
            seg = tokenizer.encode(text)
        ids.extend(seg)
        mask.extend([loss] * len(seg))
    ids_a = np.asarray(ids[:max_len], np.int32)
    mask_a = np.asarray(mask[:max_len], np.float32)
    if mask_a.size:
        mask_a[-1] = 0.0     # ref CustomDataset: last position never trains
    return ids_a, mask_a


# ---------------------------------------------------------------------------
# fixed-bucket padding collation (ref DataCollatorWithPadding, static-shape)
# ---------------------------------------------------------------------------

def pick_bucket(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def collate(examples: List[Tuple[np.ndarray, np.ndarray]],
            bucket: int) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad each (ids, mask) to `bucket` and stack: pad ids with 0 and
    mask with 0 (padding never trains; the trainers' attention is causal
    over positions so right-pad positions only see real history)."""
    B = len(examples)
    ids = np.zeros((B, bucket), np.int32)
    mask = np.zeros((B, bucket), np.float32)
    for i, (x, m) in enumerate(examples):
        n = min(len(x), bucket)
        ids[i, :n] = x[:n]
        mask[i, :n] = m[:n]
    return ids, mask


def conversation_batches(conversations: List[List[dict]], tokenizer,
                         batch_size: int,
                         template: Optional[ChatTemplate] = None,
                         max_len: int = 2048,
                         buckets: Sequence[int] = DEFAULT_BUCKETS,
                         seed: int = 0, drop_remainder: bool = False
                         ) -> Iterable[Tuple[np.ndarray, np.ndarray]]:
    """Shuffle, tokenize, group by bucket, yield (ids [B, T], mask [B, T]).

    Grouping by bucket keeps every batch one of len(buckets) static shapes
    (a trainer sees one shape each) instead of the reference collator's
    max-in-batch dynamic padding."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(conversations))
    pending: Dict[int, List] = {}
    # clamp to the bucket ladder: a row longer than the largest bucket would
    # otherwise be silently chopped at collate time, possibly losing every
    # assistant span while still occupying a batch slot
    max_len = min(max_len, max(buckets))
    for i in order:
        ex = tokenize_conversation(tokenizer, conversations[i], template,
                                   max_len)
        if ex[1].sum() == 0:           # nothing to train on
            continue
        b = pick_bucket(len(ex[0]), buckets)
        pending.setdefault(b, []).append(ex)
        if len(pending[b]) == batch_size:
            yield collate(pending.pop(b), b)
    if not drop_remainder:
        for b, exs in sorted(pending.items()):
            # pad the short batch with repeats of its first row: shapes stay
            # static and repeated rows only re-weight the (averaged) loss
            while len(exs) < batch_size:
                exs.append(exs[0])
            yield collate(exs, b)


def conversation_data_epochs(path: str, tokenizer, batch_size: int,
                             template: Optional[ChatTemplate] = None,
                             max_len: int = 2048,
                             buckets: Sequence[int] = DEFAULT_BUCKETS,
                             seed: int = 0,
                             system: str = _DEFAULT_SYSTEM) -> Callable:
    """Build the `data_epochs(epoch)` callable `train.loop.train_loop`
    consumes: re-shuffled per epoch (seed + epoch), batches of
    (input_ids, loss_mask) ready for the eagle1/eagle3 train steps."""
    convs = load_sharegpt(path, system=system)

    def data_epochs(epoch: int):
        return conversation_batches(convs, tokenizer, batch_size, template,
                                    max_len, buckets, seed=seed + epoch)

    return data_epochs


def as_tensor(a, device) -> torch.Tensor:
    """A numpy batch array (any strides) or a tensor, on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ---------------------------------------------------------------------------
# hidden-state noise augmentation (ref AddGaussianNoise / AddUniformNoise)
# ---------------------------------------------------------------------------

def add_gaussian_noise(generator: Optional[torch.Generator],
                       hidden: torch.Tensor, std: float = 0.0,
                       mean: float = 0.0) -> torch.Tensor:
    """hidden + N(mean, std) — ref AddGaussianNoise (train/main.py:108-117),
    drawn in f32 from `generator` on hidden's device. The identity (the
    same tensor) when std and mean are 0."""
    if std == 0.0 and mean == 0.0:
        return hidden
    noise = torch.randn(hidden.shape, generator=generator,
                        device=hidden.device) * std + mean
    return hidden + noise.to(hidden.dtype)


def add_uniform_noise(generator: Optional[torch.Generator],
                      hidden: torch.Tensor, std: float = 0.0) -> torch.Tensor:
    """hidden + (U[0,1) - 0.5) * std * 512 / T with T the sequence axis —
    ref AddUniformNoise (train/main.py:120-130; its tensors are [1, T, D] so
    `shape[1]` is the sequence length). The identity when std is 0."""
    if std == 0.0:
        return hidden
    T = hidden.shape[-2]
    noise = (torch.rand(hidden.shape, generator=generator,
                        device=hidden.device) - 0.5) * (std * 512.0 / T)
    return hidden + noise.to(hidden.dtype)


# ---------------------------------------------------------------------------
# precomputed-feature rows (ref CustomDataset shift contract)
# ---------------------------------------------------------------------------

def offline_example(data: Dict[str, np.ndarray], max_len: int = 2048
                    ) -> Dict[str, np.ndarray]:
    """Shape one precomputed-feature row the way the reference's
    CustomDataset does (train/main.py:133-172): truncate to max_len, shift
    ids/hidden left by one into `input_ids`/`target` (zero-padded at the
    end), keep the unshifted hidden as `hidden_state_big`, zero the final
    loss-mask position. Inputs: {hidden_state [T, D], input_ids [T],
    loss_mask [T]}."""
    h = np.asarray(data["hidden_state"], np.float32)[:max_len]
    ids = np.asarray(data["input_ids"], np.int32)[:max_len]
    m = np.asarray(data["loss_mask"], np.float32)[:max_len].copy()
    T, D = h.shape
    ids_t = np.concatenate([ids[1:], np.zeros((1,), np.int32)])
    target = np.concatenate([h[1:], np.zeros((1, D), np.float32)], axis=0)
    if T:
        m[-1] = 0.0
    return {"input_ids": ids_t, "hidden_state_big": h, "target": target,
            "loss_mask": m, "attention_mask": np.ones((T,), np.float32)}


def collate_offline(rows: List[Dict[str, np.ndarray]], bucket: int
                    ) -> Dict[str, np.ndarray]:
    """Stack offline_example rows right-padded to `bucket` (the reference
    collator's field set, static-shape)."""
    B = len(rows)
    D = rows[0]["hidden_state_big"].shape[-1]
    out = {
        "input_ids": np.zeros((B, bucket), np.int32),
        "hidden_state_big": np.zeros((B, bucket, D), np.float32),
        "target": np.zeros((B, bucket, D), np.float32),
        "loss_mask": np.zeros((B, bucket), np.float32),
        "attention_mask": np.zeros((B, bucket), np.float32),
    }
    for i, r in enumerate(rows):
        n = min(len(r["input_ids"]), bucket)
        for k in out:
            out[k][i, :n] = r[k][:n]
    return out
