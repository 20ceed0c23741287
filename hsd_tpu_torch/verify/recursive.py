"""Recursive backward verification round (port of
`hsd_tpu/verify/recursive.py`; see that module for the derivation).

One round is the raw-frontier backward verifier over the block's
accumulated trajectory: joint prefix products from the block start, the
step-back pass over the new tail [hist_len, cand_len) only, the frontier
test on the raw joint ratio of the whole trajectory, and on rejection one
resample from the stop position's normalized residual. The caller keeps
the recursion: the history's p-rows are replaced by the previous round's
residual rows (`resid_rows`).

Noise bundle: {"u": [L], "u2": 0-d, "gumbel": [V]} — the JAX package draws
them at fold_in(key, 0), fold_in(key, 1) and fold_in(key, 2).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.sampling import gumbel, uniform
from .common import TINY, categorical, gather_token_probs, last_true_index, \
    normalize


def recursive_noise(L: int, V: int, generator: Optional[torch.Generator],
                    device) -> dict:
    return {"u": uniform((L,), generator, device),
            "u2": uniform((), generator, device),
            "gumbel": gumbel((V,), generator, device)}


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, torch.log(torch.clamp(x, min=TINY)),
                       float("-inf"))


def recursive_round(cand_tokens: torch.Tensor, q: torch.Tensor,
                    p: torch.Tensor, hist_len: int, cand_len: int,
                    noise: Optional[dict] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """cand_tokens [gamma] (history then the fresh tail); q [gamma, V];
    p [gamma + 1, V] (p[cand_len] the bonus row); hist_len < cand_len <=
    gamma, host ints. Returns (tokens [gamma + 1], n_commit, full,
    resid_rows [gamma, V]) as 0-d / device tensors: tokens[:n_commit] are
    the round's newly committed tokens."""
    L = cand_tokens.shape[0]
    V = q.shape[-1]
    dev = q.device
    if noise is None:
        noise = recursive_noise(L, V, generator, dev)
    rel = torch.arange(L, device=dev)
    valid = rel < cand_len
    is_tail = valid & (rel >= hist_len)
    xc = torch.clamp(cand_tokens, 0, V - 1)
    q_rows = q[:L].float()
    p_rows = p[:L].float()
    q_i = torch.where(valid, gather_token_probs(q_rows, xc), 1.0)
    p_i = torch.where(valid, gather_token_probs(p_rows, xc), 1.0)
    log_q_i = torch.where(valid, torch.log(torch.clamp(q_i, min=TINY)), 0.0)
    log_p_i = torch.where(valid, _safe_log(p_i), 0.0)

    zero1 = torch.zeros((1,), dtype=torch.float32, device=dev)
    log_jq_prev = torch.cat([zero1, torch.cumsum(log_q_i, 0)[:-1]])
    log_jp_prev = torch.cat([zero1, torch.cumsum(log_p_i, 0)[:-1]])
    r = torch.exp(torch.clamp(log_jp_prev - log_jq_prev, max=80.0))

    diffs = r[:, None] * p_rows - q_rows
    plus = torch.clamp(diffs, min=0.0)
    s_plus = torch.sum(plus, dim=-1)
    s_minus = torch.sum(torch.clamp(-diffs, min=0.0), dim=-1)
    denom = torch.maximum(s_plus, s_minus)
    p_primes = torch.where(denom[:, None] > 0,
                           plus / torch.clamp(denom, min=TINY)[:, None], 0.0)
    sbp = torch.where(denom > 0, 1.0 - s_plus / torch.clamp(denom, min=TINY),
                      0.0)
    sbp = torch.clamp(sbp, 0.0, 1.0)

    not_stepped_back = (noise["u"] >= sbp) & is_tail
    hist = torch.full((), hist_len, dtype=torch.int64, device=dev)
    stop = torch.where(torch.any(not_stepped_back),
                       last_true_index(not_stepped_back), hist)

    log_joint_ratio = torch.sum(log_p_i - log_q_i)
    full = torch.log(torch.clamp(noise["u2"], min=TINY)) <= log_joint_ratio
    csm = torch.where(full, torch.full_like(hist, cand_len), stop)

    stop_row = torch.clamp(csm, 0, L - 1)
    onehot = F.one_hot(xc[stop_row], V).float()
    resid = normalize(p_primes[stop_row], fallback=onehot)
    bonus_row = min(max(cand_len, 0), p.shape[0] - 1)
    final_dist = torch.where(full, p[bonus_row].float(), resid)
    t = categorical(final_dist, noise["gumbel"])

    n_acc = csm - hist_len
    out_rel = torch.arange(L + 1, device=dev)
    src = cand_tokens[torch.clamp(out_rel + hist_len, 0, L - 1)]
    out = torch.where(out_rel < n_acc, src, torch.zeros_like(src))
    out[torch.clamp(n_acc, 0, L)] = t
    resid_rows = torch.where(s_plus[:, None] > 0,
                             plus / torch.clamp(s_plus, min=TINY)[:, None],
                             0.0)
    return out, n_acc + 1, full, resid_rows
