"""Trie (tree-draft) verification for EAGLE-style drafting (port of
`hsd_tpu/verify/trie.py`).

Candidates are the trie's root->leaf paths: rows [R, L] of token ids, col 0
= the committed root, -1 padding. `p` is either the materialized per-path
rows [R, L, V] (p[r, j] = the target distribution after path tokens 0..j)
or the tuple (probs [N+1, V], retrieve_indices [R, L]) straight from the
engine, which gathers node rows on demand. Draft proposals are deterministic
top-k, so q == 1 per drafted token.

The JAX package verifies one slot per call and vmaps over slots; here every
argument carries a leading slot axis [B] and each function verifies all B
problems at once. The loops over levels (typical) and rows (trie-HSD) run in
Python: typical's over device tensors with masks in place of `lax.cond`;
trie-HSD's on the host (see its docstring), with one small sync per round
that runs.

All return (best_row [B], accept_len [B], sample_p [B, V]): accept_len
counts accepted tokens BEYOND the root.

Noise bundles reproduce the JAX draws when handed them (tests); else they
are drawn from `generator`:
  typical: {"u": [B, L-1, R]}, row j of level i at fold_in(key, i*R + j);
  trie-HSD: {"u": [B, R, L], "u2": [B, R]}, row b at fold_in(key, 2b) and
  fold_in(key, 2b + 1).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.sampling import uniform
from .common import TINY


def _paths_view(p, L: int):
    """Accessors over either `p` layout: row(r [B], j [B]) -> [B, V] f32,
    the distribution after tokens 0..j of row r; path(toks [B, R, L]) ->
    [B, R, L] f32, the probability of token j of each row after the row's
    tokens before it (j >= 1); and V."""
    if isinstance(p, tuple):
        probs, ri = p
        probs = probs.float()
        B, N1, V = probs.shape
        bi = torch.arange(B, device=probs.device)

        def row(r, j):
            return probs[bi, torch.clamp(ri[bi, r, j], 0, N1 - 1)]

        def path(toks):
            prev = torch.clamp(torch.cat([ri[..., :1], ri[..., :-1]], -1),
                               0, N1 - 1)
            return probs[bi[:, None, None], prev, toks]

        return row, path, V
    pf = p.float()
    B, V = pf.shape[0], pf.shape[-1]
    bi = torch.arange(B, device=pf.device)

    def row(r, j):
        return pf[bi, r, j]

    def path(toks):
        prev = torch.cat([pf[:, :, :1], pf[:, :, :-1]], 2)
        return torch.gather(prev, 3, toks[..., None])[..., 0]

    return row, path, V


def verify_trie_greedy(candidates: torch.Tensor, p):
    """Greedy path acceptance (reference utils.py:362-375): the longest path
    that matches the target's argmax chain. candidates [B, R, L]."""
    B, R, L = candidates.shape
    if isinstance(p, tuple):
        probs, ri = p
        node_arg = torch.argmax(probs, dim=-1)                  # [B, N+1]
        tgt = torch.gather(node_arg, 1, torch.clamp(
            ri, 0, probs.shape[1] - 1).reshape(B, R * L)).reshape(B, R, L)
    else:
        tgt = torch.argmax(p, dim=-1)                           # [B, R, L]
    match = (candidates[:, :, 1:] == tgt[:, :, :-1]) & (candidates[:, :, 1:] >= 0)
    acc_len = torch.cumprod(match.to(torch.int64), dim=2).sum(2)  # [B, R]
    accept_length = acc_len.max(1).values
    best = torch.where(accept_length == 0, 0, torch.argmax(acc_len, 1))
    row, _, _ = _paths_view(p, L)
    return best, accept_length, row(best, accept_length)


def typical_noise(B: int, R: int, L: int, generator, device) -> dict:
    return {"u": uniform((B, L - 1, R), generator, device)}


def verify_trie_typical(candidates: torch.Tensor, p,
                        noise: Optional[dict] = None,
                        generator: Optional[torch.Generator] = None):
    """EAGLE's default sampling verification (reference utils.py:377-418):
    at each level try the accepted node's children in row order, accept
    child x with probability gtp[x], and on rejection zero gtp[x] and
    renormalize (exactly lossless with one-hot q). The row loop has the JAX
    package's closed form: m_j, the mass rejected before row j, is the
    exclusive cumulative sum of the usable token masses."""
    B, R, L = candidates.shape
    prow, _, V = _paths_view(p, L)
    dev = candidates.device
    if noise is None:
        noise = typical_noise(B, R, L, generator, dev)
    bi = torch.arange(B, device=dev)
    pos = torch.arange(L, device=dev)
    rows = torch.arange(R, device=dev)
    earlier = torch.tril(torch.ones((R, R), dtype=torch.bool, device=dev), -1)
    zero = torch.zeros((B,), dtype=torch.int64, device=dev)
    acc_len = zero + 1
    best = zero
    sample_p = prow(zero, zero)
    adjust = torch.zeros((B,), dtype=torch.bool, device=dev)
    done = adjust.clone()
    for i in range(1, L):
        active = (~done) & (acc_len == i)
        prefix = candidates[bi, best]                           # [B, L]
        is_eq = torch.all(torch.where(pos < i, candidates == prefix[:, None],
                                      True), dim=2)             # [B, R]
        fi = torch.argmax(is_eq.to(torch.int64), 1)
        gtp0 = prow(fi, zero + i - 1)                           # [B, V]
        tok = candidates[:, :, i]                               # [B, R]
        same = tok[:, None, :] == tok[:, :, None]               # [B, a, c]
        dup = torch.any(same & earlier & is_eq[:, None, :], dim=2)
        usable = is_eq & (~dup) & (tok >= 0)
        xc = torch.clamp(tok, 0, V - 1)
        probs0 = torch.gather(gtp0, 1, xc)
        u = noise["u"][:, i - 1]
        pu = torch.where(usable, probs0, 0.0)
        m = torch.cumsum(pu, 1) - pu
        acc_flags = usable & (u <= probs0 / torch.clamp(1.0 - m, min=TINY))
        accepted = torch.any(acc_flags, 1)
        first = torch.argmax(acc_flags.to(torch.int64), 1)
        bestj = torch.where(accepted, first, best)
        rejf = usable & (rows[None] < torch.where(accepted, first, R)[:, None])
        adj = torch.any(rejf, 1)
        zeroed = torch.zeros((B, V), device=dev).scatter_reduce(
            1, xc, rejf.float(), reduce="amax")
        gtp_z = gtp0 * (1.0 - zeroed)
        s = torch.sum(gtp_z, 1, keepdim=True)
        gtp = torch.where((adj[:, None] & (s > 0)),
                          gtp_z / torch.clamp(s, min=TINY),
                          torch.where(adj[:, None], gtp_z, gtp0))
        step = active & accepted
        acc_len = torch.where(step, acc_len + 1, acc_len)
        best = torch.where(step, bestj, best)
        sample_p = torch.where(active[:, None], gtp, sample_p)
        adjust = torch.where(active, adj, adjust)
        done = done | (active & ~accepted)
    use_resid = adjust & (acc_len != L)
    bonus = prow(best, torch.clamp(acc_len - 1, 0, L - 1))
    return (best, acc_len - 1,
            torch.where(use_resid[:, None], sample_p, bonus))


def hsd_noise(B: int, R: int, L: int, generator, device) -> dict:
    return {"u": uniform((B, R, L), generator, device),
            "u2": uniform((B, R), generator, device)}


def verify_trie_hsd(candidates: torch.Tensor, p, noise: Optional[dict] = None,
                    generator: Optional[torch.Generator] = None,
                    frontier: str = "capped"):
    """Trie-HSD (reference utils.py:420-627): hierarchical joint
    verification over paths, one round per candidate row that shares the
    accepted prefix, with one-hot q. frontier: 'capped' (exact; the joint
    ratio includes the carried residual seed) or 'raw' (`hsd_ref`, the
    committed reference's window product).

    With one-hot q every decision is a scalar function of the target
    probabilities of the drafted tokens, so the rounds run on the host in
    float32 over one copy of those [B, R, L] values and of the uniforms;
    only the residual row each round leaves behind (a [B, V] vector) is
    built on the device, and its sum and its values at the drafted tokens
    come back for the next round. Rows whose prefix gate fails for every
    problem are skipped, as the JAX `while_loop` and `cond` skip them."""
    B, R, L = candidates.shape
    prow, path, V = _paths_view(p, L)
    dev = candidates.device
    if noise is None:
        noise = hsd_noise(B, R, L, generator, dev)
    f32 = np.float32
    tiny = f32(TINY)
    toks = torch.clamp(candidates, 0, V - 1)
    host = torch.cat([candidates.float().reshape(B, -1),
                      path(toks).reshape(B, -1),
                      noise["u"].float().reshape(B, -1),
                      noise["u2"].float()], 1).cpu().numpy()
    RL = R * L
    cand = host[:, :RL].astype(np.int64).reshape(B, R, L)
    pp = host[:, RL:2 * RL].reshape(B, R, L)
    uu = host[:, 2 * RL:3 * RL].reshape(B, R, L)
    uu2 = host[:, 3 * RL:]

    ar = np.arange(B)
    rel = np.arange(L)
    row_len = (cand >= 0).sum(2)                                # [B, R]
    n = np.ones(B, np.int64)
    ind = np.zeros(B, np.int64)
    done = np.zeros(B, bool)
    has_seed = np.zeros(B, bool)
    log_jp_seed = np.zeros(B, f32)
    last_lb = row_len[:, 0].copy()
    rs = np.zeros(B, f32)                   # sum of the residual
    rv = np.zeros((B, R, L), f32)           # residual at each drafted token
    resid = torch.zeros((B, V), dtype=torch.float32, device=dev)
    flat_toks = toks.reshape(B, -1)

    for b in range(R):
        gate = np.all(np.where(rel < n[:, None], cand[:, b] == cand[ar, ind],
                               True), 1)
        act = gate & ~done
        if not act.any():
            continue
        Lb = row_len[:, b]
        idx = np.clip(n[:, None] + rel, 0, L - 1)               # [B, L]
        valid = rel < (Lb - n)[:, None]
        p_i = pp[:, b][ar[:, None], idx]
        seed0 = np.where(rs > 0, rv[:, b][ar, idx[:, 0]] / np.maximum(rs, tiny),
                         f32(0))
        p_i[:, 0] = np.where(has_seed, seed0, p_i[:, 0])
        p_i = np.where(valid, p_i, f32(1))
        with np.errstate(divide="ignore"):
            log_p_i = np.where(valid & (p_i > 0),
                               np.log(np.maximum(p_i, tiny)),
                               np.where(valid, f32(-np.inf), f32(0)))
        seed_p = np.where(has_seed, log_jp_seed, f32(0))
        log_jp_prev = seed_p[:, None] + np.concatenate(
            [np.zeros((B, 1), f32), np.cumsum(log_p_i, 1)[:, :-1]], 1)
        # q-side joints are exactly 1: r = min(Jp, Jq) / Jq
        r = np.exp(np.minimum(log_jp_prev, f32(0)))
        e = valid.astype(f32)
        pv = np.where(valid, p_i, f32(0))
        rp = r * pv
        s_plus = r * (f32(1) - pv) + np.maximum(rp - e, f32(0))
        s_minus = np.maximum(e - rp, f32(0))
        denom = np.maximum(s_plus, s_minus)
        with np.errstate(divide="ignore", invalid="ignore"):
            sbp = np.where(denom > 0,
                           f32(1) - s_plus / np.maximum(denom, tiny), f32(1))
        sbp = np.where(log_jp_prev >= 0, f32(0), sbp)
        sbp = np.clip(np.where(valid, sbp, f32(1)), 0, 1)
        not_sb = uu[:, b] >= sbp
        last = L - 1 - np.argmax(not_sb[:, ::-1], 1)
        stop_rel = np.where(not_sb.any(1), last, 0)
        num_valid = valid.sum(1)
        if frontier == "capped":
            log_acc = np.minimum(log_jp_prev, f32(0)) + log_p_i
            log_ratio = log_acc[ar, np.clip(num_valid - 1, 0, L - 1)]
        else:
            log_ratio = log_p_i.sum(1, dtype=f32)
        accept_all = np.log(np.maximum(uu2[:, b], tiny)) <= log_ratio
        csm = np.where(accept_all, num_valid, stop_rel)
        n_new = n + csm

        # the residual row at the stop position, on the device:
        # max(r_s * base - e_s * onehot(x_s), 0) / denom_s with base the
        # stop row's target distribution, or the normalized seed residual
        sr = np.clip(csm, 0, L - 1)
        use_seed = has_seed & (sr == 0)
        scal = torch.from_numpy(np.stack([
            r[ar, sr], e[ar, sr], denom[ar, sr], act.astype(f32),
            use_seed.astype(f32)])).to(dev)
        ints = torch.from_numpy(np.stack([
            np.full(B, b), np.clip(idx[ar, sr] - 1, 0, L - 1),
            np.clip(cand[:, b][ar, idx[ar, sr]], 0, V - 1)])).to(dev)
        base = prow(ints[0], ints[1])
        if use_seed.any():
            rs_d = resid.sum(1, keepdim=True)
            row0 = torch.where(rs_d > 0, resid / torch.clamp(rs_d, min=TINY),
                               0.0)
            base = torch.where(scal[4, :, None] > 0, row0, base)
        y = (scal[0, :, None] * base).scatter_add(1, ints[2, :, None],
                                                   -scal[1, :, None])
        d_s = scal[2, :, None]
        new_resid = torch.where(d_s > 0, torch.clamp(y, min=0.0)
                                / torch.clamp(d_s, min=TINY), 0.0)
        resid = torch.where(scal[3, :, None] > 0, new_resid, resid)
        back = torch.cat([resid.sum(1, keepdim=True),
                          torch.gather(resid, 1, flat_toks)], 1).cpu().numpy()
        rs, rv = back[:, 0], back[:, 1:].reshape(B, R, L)

        log_jp_seed = np.where(act, log_jp_prev[ar, sr], log_jp_seed)
        n = np.where(act, n_new, n)
        ind = np.where(act, b, ind)
        has_seed = has_seed | act
        done = np.where(act, n_new >= L, done)
        last_lb = np.where(act, Lb, last_lb)

    # final sampling distribution (reference utils.py:607-627)
    fb_idx = np.where(n + 1 < last_lb, np.clip(n + 1, 0, L - 1),
                      np.clip(n, 0, L - 1))
    state = torch.from_numpy(np.stack([
        ind, n, np.clip(last_lb - 1, 0, L - 1),
        np.clip(cand[ar, ind, fb_idx], 0, V - 1),
        (n < last_lb).astype(np.int64)])).to(dev)
    bonus = prow(state[0], state[2])
    rs_d = resid.sum(1, keepdim=True)
    fallback = F.one_hot(state[3], V).to(torch.float32)
    resample = torch.where(rs_d > 0, resid / torch.clamp(rs_d, min=TINY),
                           fallback)
    sample_p = torch.where(state[4, :, None] > 0, resample, bonus)
    return state[0], state[1] - 1, sample_p
