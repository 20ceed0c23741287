"""Reduced draft-vocabulary construction (d2t / t2d); port of
`hsd_tpu/train/draft_vocab.py`, numpy only, bit for bit.

The counterpart of the reference's `scandata` (traineagle3/cnets.py:518-666):
scan a token corpus, keep the top-N most frequent target tokens as the draft
vocabulary, and emit the two index maps the EAGLE-3 head uses:
  d2t[j] = target_id(j) - j   (offset form, matching the checkpoint buffers)
  t2d[v] = v in draft vocab   (bool mask over the target vocab)
Counting is a numpy bincount over pre-tokenized ids (shard + sum for large
corpora).
"""
from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np


def count_tokens(id_chunks: Iterable[np.ndarray], vocab_size: int) -> np.ndarray:
    counts = np.zeros((vocab_size,), np.int64)
    for chunk in id_chunks:
        counts += np.bincount(np.asarray(chunk).reshape(-1),
                              minlength=vocab_size)
    return counts


def build_draft_vocab(counts: np.ndarray, draft_vocab_size: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-`draft_vocab_size` tokens by frequency -> (d2t offsets, t2d mask).

    Draft slots are sorted by target id (so d2t is monotone), matching the
    reference's buffer convention (target_id = draft_id + d2t[draft_id])."""
    V = counts.shape[0]
    top = np.argsort(-counts, kind="stable")[:draft_vocab_size]
    top = np.sort(top)
    d2t = (top - np.arange(draft_vocab_size)).astype(np.int32)
    t2d = np.zeros((V,), bool)
    t2d[top] = True
    return d2t, t2d
