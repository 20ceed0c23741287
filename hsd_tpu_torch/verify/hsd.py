"""Hierarchical Speculative Decoding verification — the clever (smart-capping)
single-pass form with multidraft reseeding (port of `hsd_tpu/verify/hsd.py`).
See that module for the math; prefix products live in log space and the
divergence is the scale-free r[k] * p[k, :] - q[k, :]. Row layouts as in
verify/tokenwise.py: parallel (round b examines row b) or striped (row
n * (K - 1) + b).

frontier: 'capped' (exact, the default) or 'raw' (`hsd_ref`, the committed
reference's raw joint ratio, biased by design). In the striped layout the
capped frontier gates each round's row on the accepted prefix, which makes
it exact; 'raw' keeps the reference's ungated rows.

Noise bundle: {"u": [K, gamma], "u2": [K], "gumbel": [V]} — the JAX package
draws them at fold_in(key, 3b), fold_in(key, 3b+1) and fold_in(key, 3K+2).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.sampling import gumbel, uniform
from .common import (TINY, VerifyResult, categorical, gather_token_probs,
                     last_true_index, normalize, prefix_matches, scalar,
                     scatter_commit, telemetry_zeros, window_index)


def hsd_noise(K: int, gamma: int, V: int,
              generator: Optional[torch.Generator], device) -> dict:
    return {"u": uniform((K, gamma), generator, device),
            "u2": uniform((K,), generator, device),
            "gumbel": gumbel((V,), generator, device)}


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    """log with exact zeros mapped to -inf (no NaNs)."""
    return torch.where(x > 0, torch.log(torch.clamp(x, min=TINY)),
                       float("-inf"))


def verify_hsd(draft_tokens: torch.Tensor, q: torch.Tensor, p: torch.Tensor,
               noise: Optional[dict] = None,
               generator: Optional[torch.Generator] = None,
               num_drafts: int = 0, frontier: str = "capped",
               return_telemetry: bool = False, striped: bool = False):
    """HSD-clever verification over K drafts, in the parallel or (striped)
    the striped row layout. With return_telemetry, returns (VerifyResult,
    Telemetry): per round, the step-back probabilities of the window's
    valid positions and p_i, q_i."""
    R, gamma = draft_tokens.shape
    K = num_drafts if num_drafts else R
    V = p.shape[-1]
    dev = p.device
    if noise is None:
        noise = hsd_noise(K, gamma, V, generator, dev)
    i64, f32 = torch.int64, torch.float32

    n = scalar(0, i64, dev)
    ind = scalar(0, i64, dev)
    done = scalar(False, torch.bool, dev)
    rounds = scalar(0, i64, dev)
    resid_row = torch.zeros((V,), dtype=f32, device=dev)
    log_jq_seed = scalar(0.0, f32, dev)
    log_jp_seed = scalar(0.0, f32, dev)
    has_seed = scalar(False, torch.bool, dev)
    zeros_v = torch.zeros((V,), dtype=f32, device=dev)
    zero1 = torch.zeros((1,), dtype=f32, device=dev)
    tel = telemetry_zeros(K, gamma, dev) if return_telemetry else None

    for b in range(K):
        if striped:
            row = row_id = torch.clamp(n * (K - 1) + b, 0, R - 1)
        else:
            row, row_id = b, scalar(b, i64, dev)
        if striped and frontier != "capped":
            active = ~done
        else:
            active = (~done) & prefix_matches(draft_tokens, row, ind, n)
        d_row, q_all, p_all = draft_tokens[row], q[row], p[row]
        idx, valid = window_index(n, gamma)
        x = d_row[idx]

        q_rows = q_all[idx].to(f32)
        p_rows = p_all[idx].to(f32).clone()
        row0 = normalize(resid_row, fallback=zeros_v)
        p_rows[0] = torch.where(has_seed, row0, p_rows[0])

        q_i = torch.where(valid, gather_token_probs(q_rows, x), 1.0)
        p_i = torch.where(valid, gather_token_probs(p_rows, x), 1.0)

        log_q_i = torch.where(valid, _safe_log(torch.clamp(q_i, min=TINY)), 0.0)
        log_p_i = torch.where(valid, _safe_log(p_i), 0.0)

        seed_q = torch.where(has_seed, log_jq_seed, 0.0)
        seed_p = torch.where(has_seed, log_jp_seed, 0.0)
        log_jq_prev = seed_q + torch.cat([zero1, torch.cumsum(log_q_i, 0)[:-1]])
        log_jp_prev = seed_p + torch.cat([zero1, torch.cumsum(log_p_i, 0)[:-1]])

        # smart capping in log space
        log_ratio = log_jp_prev - log_jq_prev
        log_cap = torch.cummax(torch.clamp(log_ratio, min=0.0), dim=0).values
        r = torch.exp(log_jp_prev - log_cap - log_jq_prev)

        diffs = r[:, None] * p_rows - q_rows
        p_plus = torch.clamp(diffs, min=0.0)
        s_plus = torch.sum(p_plus, dim=-1)
        s_minus = torch.sum(torch.clamp(-diffs, min=0.0), dim=-1)
        denom = torch.maximum(s_plus, s_minus)
        p_primes = torch.where(denom[:, None] > 0,
                               p_plus / torch.clamp(denom, min=TINY)[:, None],
                               0.0)

        sbp = torch.where(denom > 0,
                          1.0 - s_plus / torch.clamp(denom, min=TINY), 0.0)
        sbp = torch.clamp(sbp, 0.0, 1.0)
        sbp_masked = torch.where(valid, sbp, 1.0)

        u = noise["u"][b]
        not_stepped_back = u >= sbp_masked
        stop_rel = last_true_index(not_stepped_back)

        num_valid = torch.sum(valid.to(i64))
        if frontier == "capped":
            log_acc = (log_jp_prev - log_cap - log_jq_prev) + log_p_i - log_q_i
            log_joint_ratio = log_acc[torch.clamp(num_valid - 1, 0, gamma - 1)]
        else:
            log_joint_ratio = torch.sum(log_p_i - log_q_i)
        u2 = noise["u2"][b]
        accept_all = torch.log(torch.clamp(u2, min=TINY)) <= log_joint_ratio
        csm = torch.where(accept_all, num_valid, stop_rel)
        n_new = n + csm
        full = n_new == gamma

        stop_row = torch.clamp(csm, 0, gamma - 1)
        new_resid = p_primes[stop_row]
        new_log_jq = log_jq_prev[stop_row]
        new_log_jp = log_jp_prev[stop_row]

        n = torch.where(active, n_new, n)
        ind = torch.where(active, row_id, ind)
        done = torch.where(active, full, done)
        resid_row = torch.where(active, new_resid, resid_row)
        log_jq_seed = torch.where(active, new_log_jq, log_jq_seed)
        log_jp_seed = torch.where(active, new_log_jp, log_jp_seed)
        has_seed = torch.where(active, ~full, has_seed)
        rounds = rounds + active.to(i64)
        if return_telemetry:
            for row, val in zip(tel, (torch.where(valid, sbp, 0.0), p_i, q_i)):
                row[b] = torch.where(active, val, row[b])

    ind_c = torch.clamp(ind, 0, R - 1)
    bonus = p.to(f32)[ind_c, gamma]
    onehot = F.one_hot(draft_tokens[ind_c, torch.clamp(n, 0, gamma - 1)],
                       V).to(f32)
    resample = normalize(resid_row, fallback=onehot)
    final_dist = torch.where(done, bonus, resample)
    t = categorical(final_dist, noise["gumbel"])
    tokens = scatter_commit(draft_tokens[ind_c], t, n)
    result = VerifyResult(tokens=tokens, n_matches=n, draft_index=ind,
                          rounds=rounds)
    return (result, tel) if return_telemetry else result
