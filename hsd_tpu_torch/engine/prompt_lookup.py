"""Prompt-lookup (n-gram) drafting, without a draft model (port of
`hsd_tpu/engine/prompt_lookup.py`): the candidate continuation is the text
that followed the most recent earlier occurrence of the context's longest
matching suffix n-gram. Proposals have q = one-hot, so a token is accepted
with probability p(x).

The JAX package searches the context with a vectorized match on the
device; the port searches the host copy of the committed tokens, which the
engine already holds after each block's sync, and copies the proposal to
the device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import EngineConfig, ModelConfig
from ..models import transformer
from ..ops.sampling import processor, sample, uniform
from .kvcache import init_cache, rollback
from .speculative import final_length


def propose_ngram(tokens: Sequence[int], length: int, gamma: int,
                  max_ngram: int = 3) -> Tuple[List[int], int]:
    """Find a continuation of `tokens[:length]` (host ints; reads past
    `length` are clipped to the buffer, as `jnp.take` clips them).

    Returns (draft [gamma], n_found): the gamma tokens from just after the
    latest earlier occurrence i (i + n <= length - n) of the suffix n-gram,
    for the longest n in max_ngram..1 that has one, and n_found, how many
    of them lie inside the context (at most gamma); ([0] * gamma, 0) when
    nothing matches."""
    S = len(tokens)

    def at(i):
        return tokens[min(max(i, 0), S - 1)]

    for n in range(max_ngram, 0, -1):
        suffix = [at(length - n + j) for j in range(n)]
        for i in range(length - 2 * n, -1, -1):
            if all(at(i + j) == suffix[j] for j in range(n)):
                cont = i + n
                avail = min(max(length - cont, 0), gamma)
                if avail > 0:
                    return [at(cont + j) for j in range(gamma)], avail
                break
    return [0] * gamma, 0


def make_prompt_lookup_generate(cfg_target: ModelConfig, engine: EngineConfig,
                                max_ngram: int = 3):
    """Speculative decoding with prompt-lookup drafts: one target forward
    verifies gamma looked-up tokens per block. Returns `generate(params_t,
    prompt, prompt_len, generator) -> (tokens [S], length, accepts
    [max_new] (-1 unused), blocks)`."""
    gamma = engine.verifier.gamma
    temp = processor(engine.temperature, engine.top_k, engine.top_p)
    max_new = engine.max_new_tokens
    eos = cfg_target.eos_token_id

    def generate(params_t, prompt: torch.Tensor, prompt_len: int,
                 generator: Optional[torch.Generator] = None):
        dev = prompt.device
        P = prompt.shape[0]
        S = P + max_new + gamma + 2
        start = torch.full((1,), P - int(prompt_len), dtype=torch.int64,
                           device=dev)
        cache = init_cache(cfg_target, 1, S, dev).replace(start=start)
        _, cache = transformer.forward(cfg_target, params_t, prompt[None, :-1],
                                       cache, skip_head=True)
        tokens = torch.zeros((S,), dtype=torch.int64, device=dev)
        tokens[:P] = prompt
        host = prompt.tolist() + [0] * (S - P)
        ar = torch.arange(gamma, device=dev)
        accepts = []
        length, done = P, False
        while not done and length - P < max_new and len(accepts) < max_new:
            draft_host, n_found = propose_ngram(host, length, gamma,
                                                max_ngram)
            draft = torch.tensor(draft_host, dtype=torch.int64, device=dev)
            tgt_in = torch.cat([tokens[length - 1:length], draft])[None]
            tlogits, cache = transformer.forward(cfg_target, params_t,
                                                 tgt_in, cache)
            probs = temp(tlogits[0])                        # [gamma+1, V]
            # accept x_j iff u_j <= p(x_j) (q = 1), over the n_found proposed
            px = torch.gather(probs[:gamma], 1, draft[:, None])[:, 0]
            acc = (uniform((gamma,), generator, dev) <= px) & (ar < n_found)
            n = torch.sum(torch.cumprod(acc.long(), 0))
            # the residual of a one-hot q at the rejected token
            rej_row = probs[torch.clamp(n, 0, gamma)]
            onehot = F.one_hot(draft[torch.clamp(n, 0, gamma - 1)],
                               probs.shape[-1]).float()
            resid = torch.clamp(rej_row - onehot, min=0.0)
            rs = torch.sum(resid)
            dist = torch.where(
                n >= n_found, rej_row,
                torch.where(rs > 0, resid / torch.clamp(rs, min=1e-30),
                            rej_row))
            t = sample(dist, generator)
            # the block's one host sync
            n, t_host = torch.stack([n, t]).tolist()
            tokens[length:length + n] = draft[:n]
            tokens[length + n] = t
            host[length:length + n + 1] = draft_host[:n] + [t_host]
            length += n + 1
            cache = rollback(cache, length - 1)
            done = eos in host[length - n - 1:length]
            accepts.append(n)
        length = final_length(host, length, P, max_new, eos)
        acc_out = torch.full((max_new,), -1, dtype=torch.int64)
        acc_out[:len(accepts)] = torch.tensor(accepts, dtype=torch.int64)
        return tokens, length, acc_out, len(accepts)

    return generate
