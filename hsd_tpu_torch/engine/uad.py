"""Universal Assisted Decoding (UAD): draft and target with DIFFERENT
tokenizers (port of `hsd_tpu/engine/uad.py`).

The draft proposes in TEXT space: the target-token context is decoded,
continued by the draft under its own tokenizer, re-encoded with the target
tokenizer and aligned by the longest diagonal run of equal tokens.
Proposals carry no usable draft probabilities across tokenizers, so
verification is one-hot (accept token x with probability p(x); the
residual is p with x zeroed), which keeps the target's law exactly, as
prompt lookup does.

Host-driven by necessity (tokenizers are host code): one target forward and
one host sync per block. The tokenizer-side functions are plain Python and
numpy, kept here as the port's own copy.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import EngineConfig, ModelConfig
from ..models import transformer
from ..ops.sampling import processor, sample, uniform
from .kvcache import init_cache, rollback


def align_suffix(old_ids: List[int], new_ids: List[int]) -> int:
    """Length of the longest common prefix."""
    n = 0
    for a, b in zip(old_ids, new_ids):
        if a != b:
            break
        n += 1
    return n


def longest_diag_run(old: List[int], new: List[int]):
    """Longest diagonal run of equality between `new` (a re-encoded window)
    and `old` (the committed window): (i, j, length) with new[i + t] ==
    old[j + t] for t < length, or None when the windows share no token.
    Ties break toward the earliest diagonal start in row-major order."""
    if not old or not new:
        return None
    a = np.asarray(old)
    b = np.asarray(new)
    m = b[:, None] == a[None, :]                     # [len(new), len(old)]
    if not m.any():
        return None
    # run[i, j]: length of the run of matches ending at (i, j) on its
    # diagonal
    run = np.zeros_like(m, dtype=np.int32)
    for i in range(m.shape[0]):
        prev = (np.concatenate([[0], run[i - 1, :-1]]) if i
                else np.zeros((m.shape[1],), np.int32))
        run[i] = np.where(m[i], prev + 1, 0)
    length = int(run.max())
    starts = np.argwhere(run == length) - (length - 1)
    order = np.lexsort((starts[:, 1], starts[:, 0]))
    i0, j0 = starts[order[0]]
    return int(i0), int(j0), length


def split_new_tokens(old_window: List[int], reencoded: List[int]):
    """Split a re-encoded window against the committed one: returns
    (discrepancy_length, new_tokens, discrepancy_tokens), or None when the
    windows do not intersect. Past the longest diagonal, what still
    overlaps the committed window re-tokenized differently (the
    discrepancy); only the tokens past that overlap are new."""
    hit = longest_diag_run(old_window, reencoded)
    if hit is None:
        return None
    i0, j0, length = hit
    new_start = i0 + length
    disc_len = max(len(old_window) - (j0 + length), 0)
    discrepancy = list(reencoded[new_start:new_start + disc_len])
    new_tokens = list(reencoded[new_start + disc_len:])
    return disc_len, new_tokens, discrepancy


class UadDrafter:
    """Text-space proposal: target ids -> up to gamma NEW target ids.

    Only the last `lookbehind` committed tokens re-encode each round, and
    the re-encoded window is diagonal-matched against the committed one,
    so proposals survive re-tokenization drift (a merge across the
    committed / continuation boundary). The committed target stream stays
    authoritative: drift over committed positions is skipped, never
    rewritten."""

    def __init__(self, target_tokenizer, draft_tokenizer,
                 draft_continue: Callable[[str, int], str],
                 chars_per_token: int = 8, lookbehind: int = 10):
        self.ttok = target_tokenizer
        self.dtok = draft_tokenizer
        self.draft_continue = draft_continue
        self.cpt = chars_per_token
        self.lookbehind = lookbehind

    def propose(self, target_ids: List[int], gamma: int) -> List[int]:
        text = self.ttok.decode(target_ids)
        cont = self.draft_continue(text, gamma * self.cpt)
        if not cont:
            return []
        window = list(target_ids[-self.lookbehind:])
        wtext = self.ttok.decode(window)
        reenc = list(self.ttok.encode(wtext + cont))
        # no drift: the window re-encodes to an exact prefix
        if reenc[:len(window)] == window:
            return reenc[len(window):len(window) + gamma]
        got = split_new_tokens(window, reenc)
        if got is None:
            return []
        _, new_tokens, _ = got
        return new_tokens[:gamma]


class UadTokenDrafter:
    """Token-level UAD drafter: the draft model consumes its OWN token ids
    and keeps its id history across rounds.

      1. target -> draft: re-encode the last `target_lookbehind` committed
         target tokens (plus everything accepted since the previous round)
         into draft ids, diagonal-match them against the history's suffix,
         replace the history tail that re-tokenized differently and append
         the new draft ids;
      2. continue the history (`draft_continue_ids(ids, n) -> new ids`);
      3. draft -> target: re-encode the last `assistant_lookbehind` history
         tokens plus the continuation into target ids, diagonal-match them
         against the committed target window, and propose only the tokens
         past the overlap."""

    def __init__(self, target_tokenizer, draft_tokenizer,
                 draft_continue_ids: Callable[[List[int], int], List[int]],
                 tokens_per_target_token: int = 2,
                 target_lookbehind: int = 10, assistant_lookbehind: int = 10):
        self.ttok = target_tokenizer
        self.dtok = draft_tokenizer
        self.draft_continue_ids = draft_continue_ids
        self.tpt = tokens_per_target_token
        self.target_lookbehind = target_lookbehind
        self.assistant_lookbehind = assistant_lookbehind
        self.draft_ids: List[int] = []     # the draft-token history
        self.prev_target_len = 0

    def _to_draft(self, target_ids: List[int]) -> List[int]:
        return list(self.dtok.encode(self.ttok.decode(target_ids)))

    def propose(self, target_ids: List[int], gamma: int) -> List[int]:
        target_ids = list(target_ids)
        if not self.draft_ids or self.prev_target_len <= self.target_lookbehind:
            self.draft_ids = self._to_draft(target_ids)
        else:
            # the window: the previous round's last lookbehind target
            # tokens plus every token accepted since
            start = self.prev_target_len - self.target_lookbehind
            win_draft = self._to_draft(target_ids[start:])
            use = self.draft_ids[-len(win_draft):] if win_draft else []
            got = split_new_tokens(use, win_draft)
            if got is None:
                self.draft_ids = self.draft_ids + win_draft
            else:
                disc_len, new_tokens, disc = got
                if disc_len > 0 and disc and disc_len >= len(disc):
                    # drop the drifted tail, put its re-encoding in place
                    self.draft_ids = (
                        self.draft_ids[:-disc_len] + disc
                        if disc_len <= len(self.draft_ids) else list(disc))
                self.draft_ids = self.draft_ids + new_tokens
        self.prev_target_len = len(target_ids)

        n_draft = max(gamma * self.tpt, 1)
        cont = list(self.draft_continue_ids(list(self.draft_ids), n_draft))
        if not cont:
            return []
        self.draft_ids = self.draft_ids + cont

        look = self.draft_ids[-(self.assistant_lookbehind + len(cont)):]
        reenc_t = list(self.ttok.encode(self.dtok.decode(look)))
        window_t = target_ids[-len(reenc_t):] if reenc_t else []
        got = split_new_tokens(window_t, reenc_t)
        if got is None:
            return []
        _, new_target, _ = got
        return new_target[:gamma]


def make_uad_generate(cfg_t: ModelConfig, engine: EngineConfig, drafter,
                      device=None):
    """Speculative decoding with a different-tokenizer drafter (UadDrafter
    or UadTokenDrafter). Returns `generate(params_t, prompt_ids: List[int],
    generator) -> List[int]`, the new ids (cut after the first EOS, else at
    the budget). Each block verifies up to gamma proposed tokens one-hot
    in one target forward: uniforms [gamma], then the sample's Gumbel
    noise, drawn from `generator` (None: the global generator; at
    temperature 0 the draws do not matter). Runs on `device` (the card by
    default)."""
    dev = transformer.resolve_device(device)
    gamma = engine.verifier.gamma
    temp = processor(engine.temperature, engine.top_k, engine.top_p)
    max_new = engine.max_new_tokens
    eos = cfg_t.eos_token_id
    ar = torch.arange(gamma, device=dev)

    def generate(params_t, prompt_ids: List[int],
                 generator: Optional[torch.Generator] = None) -> List[int]:
        P = len(prompt_ids)
        S = P + max_new + gamma + 2
        prompt = torch.tensor(prompt_ids, dtype=torch.int64, device=dev)
        cache = init_cache(cfg_t, 1, S, dev)
        _, cache = transformer.forward(cfg_t, params_t, prompt[None, :-1],
                                       cache, skip_head=True)
        tokens = torch.zeros((S,), dtype=torch.int64, device=dev)
        tokens[:P] = prompt
        host = list(prompt_ids)
        length = P
        while length - P < max_new:
            prop = drafter.propose(host, gamma)[:gamma]
            n_found = len(prop)
            draft = torch.tensor((prop + [0] * gamma)[:gamma],
                                 dtype=torch.int64, device=dev)
            tgt_in = torch.cat([tokens[length - 1:length], draft])[None]
            tlogits, cache = transformer.forward(cfg_t, params_t, tgt_in,
                                                 cache)
            probs = temp(tlogits[0])                        # [gamma+1, V]
            V = probs.shape[-1]
            # accept x_j iff u_j <= p(x_j) (q one-hot), over the proposed
            u = uniform((gamma,), generator, dev)
            px = torch.gather(probs[:gamma], 1,
                              torch.clamp(draft, 0, V - 1)[:, None])[:, 0]
            acc = (u <= px) & (ar < n_found)
            n = torch.sum(torch.cumprod(acc.long(), 0))
            rej_row = probs[torch.clamp(n, 0, gamma)]
            # zeros for an id past the vocabulary, as jax.nn.one_hot gives
            onehot = (torch.arange(V, device=dev)
                      == draft[torch.clamp(n, 0, gamma - 1)]).float()
            resid = torch.clamp(rej_row - onehot, min=0.0)
            rs = torch.sum(resid)
            dist = torch.where(
                n >= n_found, rej_row,
                torch.where(rs > 0, resid / torch.clamp(rs, min=1e-30),
                            rej_row))
            t = sample(dist, generator)
            n, t_host = torch.stack([n, t]).tolist()    # the block's sync
            tokens[length:length + n] = draft[:n]
            tokens[length + n] = t
            host[length:] = prop[:n] + [t_host]
            length += n + 1
            cache = rollback(cache, length - 1)
            out = host[P:length]
            if eos in out:
                return out[:out.index(eos) + 1]
        return host[P:P + max_new]

    return generate
