"""Tokenwise (Leviathan et al.) verification with multidraft recursive
reject sampling (port of `hsd_tpu/verify/tokenwise.py`, parallel layout).

Per position j: accept x_j iff u_j <= p_j / q_j; stop at the first
rejection; resample from norm(max(p_n - q_n, 0)). Draft b > 0 continues
only if its first n tokens match the accepted prefix, with the previous
residual in place of the target row at the restart position.

Noise bundle: {"u": [K, gamma] uniforms, "gumbel": [V]} — the JAX package
draws them at fold_in(key, 2b) and fold_in(key, 2K+1).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.sampling import gumbel, uniform
from .common import (TINY, VerifyResult, categorical, gather_token_probs,
                     normalize, prefix_matches, scalar, scatter_commit,
                     telemetry_zeros, window_index)


def tokenwise_noise(K: int, gamma: int, V: int,
                    generator: Optional[torch.Generator], device) -> dict:
    return {"u": uniform((K, gamma), generator, device),
            "gumbel": gumbel((V,), generator, device)}


def verify_tokenwise(draft_tokens: torch.Tensor, q: torch.Tensor,
                     p: torch.Tensor, noise: Optional[dict] = None,
                     generator: Optional[torch.Generator] = None,
                     num_drafts: int = 0, return_telemetry: bool = False):
    """Tokenwise verification over K parallel drafts. With
    return_telemetry, returns (VerifyResult, Telemetry): per round, the
    step-back probabilities 1 - min(p_i / q_i, 1) and p_i, q_i."""
    R, gamma = draft_tokens.shape
    K = num_drafts if num_drafts else R
    V = p.shape[-1]
    dev = p.device
    if noise is None:
        noise = tokenwise_noise(K, gamma, V, generator, dev)
    i64 = torch.int64
    n = scalar(0, i64, dev)
    ind = scalar(0, i64, dev)
    resid = torch.zeros((V,), dtype=p.dtype, device=dev)
    has_resid = scalar(False, torch.bool, dev)
    done = scalar(False, torch.bool, dev)
    rounds = scalar(0, i64, dev)
    ar = torch.arange(gamma, device=dev)
    tel = telemetry_zeros(K, gamma, dev) if return_telemetry else None

    for b in range(K):
        active = (~done) & prefix_matches(draft_tokens, b, ind, n)
        d_row, q_all, p_all = draft_tokens[b], q[b], p[b]
        idx, valid = window_index(n, gamma)
        x = d_row[idx]
        q_rows = q_all[idx]
        q_i = gather_token_probs(q_rows, x)
        p_rows = p_all[idx].clone()
        p_rows[0] = torch.where(has_resid, resid, p_rows[0])
        p_i = p_rows[ar, x]
        q_i = torch.where(valid, q_i, 1.0)
        p_i = torch.where(valid, p_i, 1.0)

        u = noise["u"][b]
        accepted = (u <= p_i / torch.clamp(q_i, min=TINY)) & valid
        csm = torch.sum(torch.cumprod(accepted.to(i64), dim=0))
        n_new = n + csm
        full = n_new == gamma

        rej_p = p_rows[torch.clamp(csm, 0, gamma - 1)]
        rej_q = q_all[torch.clamp(n_new, 0, gamma - 1)]
        new_resid = normalize(torch.clamp(rej_p - rej_q, min=0.0),
                              fallback=rej_p)
        new_resid = torch.where(full, p_all[gamma], new_resid)

        n = torch.where(active, n_new, n)
        ind = torch.where(active, scalar(b, i64, dev), ind)
        resid = torch.where(active, new_resid, resid)
        has_resid = torch.where(active, ~full, has_resid)
        done = torch.where(active, full, done)
        rounds = rounds + active.to(i64)
        if return_telemetry:
            sbp = 1.0 - torch.clamp(p_i / torch.clamp(q_i, min=TINY), max=1.0)
            for row, val in zip(tel, (sbp, p_i, q_i)):
                row[b] = torch.where(active, val.float(), row[b])

    t = categorical(resid, noise["gumbel"])
    tokens = scatter_commit(draft_tokens[torch.clamp(ind, 0, R - 1)], t, n)
    result = VerifyResult(tokens=tokens, n_matches=n, draft_index=ind,
                          rounds=rounds)
    return (result, tel) if return_telemetry else result
