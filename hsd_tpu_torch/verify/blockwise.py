"""Blockwise verification (Sun et al.) and greedy verification (port of
`hsd_tpu/verify/blockwise.py`).

Blockwise carries a running accept probability a. At each position i < gamma
it samples from [max(p_i * a - q_i, 0), 1 - a]: the extra index keeps the
draft token, a vocab token v makes the output draft[:i] + [v] (the last
overwrite wins); a zero-mass vector keeps token i unconditionally. Then
a <- min(1, a * p_i / q_i). At the bonus position it accepts w.p. a.

Noise bundle: {"gumbel": [gamma, V+1], "u": [], "gumbel_bonus": [V]} — the
JAX package draws them at fold_in(key, i), fold_in(key, gamma+1) and
fold_in(key, gamma+2).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.sampling import gumbel, uniform
from .common import (TINY, VerifyResult, categorical, gather_token_probs,
                     scalar, scatter_commit)


def blockwise_noise(gamma: int, V: int, generator: Optional[torch.Generator],
                    device) -> dict:
    return {"gumbel": gumbel((gamma, V + 1), generator, device),
            "u": uniform((), generator, device),
            "gumbel_bonus": gumbel((V,), generator, device)}


def verify_blockwise(draft_tokens: torch.Tensor, q: torch.Tensor,
                     p: torch.Tensor, noise: Optional[dict] = None,
                     generator: Optional[torch.Generator] = None,
                     num_drafts: int = 0) -> VerifyResult:
    """Single-draft blockwise verification (K must be 1)."""
    if draft_tokens.shape[0] != 1:
        raise ValueError("blockwise verification is single-draft")
    gamma = draft_tokens.shape[1]
    V = p.shape[-1]
    dev = p.device
    if noise is None:
        noise = blockwise_noise(gamma, V, generator, dev)
    i64, f32 = torch.int64, torch.float32
    x = draft_tokens[0]
    qm = q[0].to(f32)
    pm = p[0].to(f32)
    q_i = gather_token_probs(qm, x)
    p_i = gather_token_probs(pm[:gamma], x)
    ratio = p_i / torch.clamp(q_i, min=TINY)

    n = scalar(0, i64, dev)
    tail = scalar(0, i64, dev)
    has_tail = scalar(True, torch.bool, dev)
    a = scalar(1.0, f32, dev)
    for i in range(gamma):
        weights = torch.clamp(pm[i] * a - qm[i], min=0.0)
        reject_w = torch.clamp(1.0 - a, min=0.0)
        total = torch.sum(weights) + reject_w
        zero_mass = total <= 0
        logits = torch.cat([torch.log(torch.clamp(weights, min=0.0)),
                            torch.log(torch.clamp(reject_w, min=0.0))[None]])
        c = torch.argmax(torch.where(zero_mass, 0.0, logits)
                         + noise["gumbel"][i])
        replaced = (~zero_mass) & (c < V)
        n = torch.where(zero_mass, scalar(i + 1, i64, dev),
                        torch.where(replaced, scalar(i, i64, dev), n))
        tail = torch.where(replaced, c, tail)
        has_tail = torch.where(zero_mass, False,
                               torch.where(replaced, True, has_tail))
        a = torch.clamp(a * ratio[i], max=1.0)

    bonus_accepted = noise["u"] >= (1.0 - a)
    bonus = categorical(pm[gamma], noise["gumbel_bonus"])
    n = torch.where(bonus_accepted, scalar(gamma, i64, dev), n)
    tail = torch.where(bonus_accepted, bonus, tail)
    has_tail = torch.where(bonus_accepted, True, has_tail)

    # no tail: exactly n draft tokens, encoded as n-1 matches + the last one
    n_eff = torch.where(has_tail, n, n - 1)
    extra = torch.where(has_tail, tail, x[torch.clamp(n - 1, 0, gamma - 1)])
    tokens = scatter_commit(x, extra, n_eff)
    return VerifyResult(tokens=tokens, n_matches=n_eff,
                        draft_index=scalar(0, i64, dev),
                        rounds=scalar(1, i64, dev))


def verify_greedy(draft_tokens: torch.Tensor, q: torch.Tensor,
                  p: torch.Tensor, noise: Optional[dict] = None,
                  generator: Optional[torch.Generator] = None,
                  num_drafts: int = 0) -> VerifyResult:
    """Greedy verification: the longest draft prefix matching the target's
    argmax, then the target's argmax at the first mismatch or bonus."""
    del q, noise, generator, num_drafts
    gamma = draft_tokens.shape[1]
    dev = p.device
    x = draft_tokens[0]
    tgt = torch.argmax(p[0], dim=-1)
    match = (x == tgt[:gamma]).to(torch.int64)
    n = torch.sum(torch.cumprod(match, dim=0))
    extra = tgt[torch.clamp(n, 0, gamma)]
    tokens = scatter_commit(x, extra, n)
    return VerifyResult(tokens=tokens, n_matches=n,
                        draft_index=scalar(0, torch.int64, dev),
                        rounds=scalar(1, torch.int64, dev))
