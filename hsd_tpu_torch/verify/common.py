"""Shared types and helpers for the verifiers (port of
`hsd_tpu/verify/common.py`).

Contract of every verifier (one verification problem):
  draft_tokens : [K, gamma] int64  — K candidate drafts
  q            : [K, gamma, V]     — draft probs
  p            : [K, gamma+1, V]   — target probs incl. the bonus position
  noise        : optional dict of the uniforms and Gumbel vectors the rule
                 consumes (see each verifier); drawn from `generator` when
                 absent. Handing both frameworks the same bundle reproduces
                 the JAX package's decisions exactly.

Output: VerifyResult. `tokens[:n_matches]` are accepted tokens of draft
`draft_index`; `tokens[n_matches]` is the resampled or bonus token. All
fields are tensors on the inputs' device: nothing syncs with the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Smallest float32-safe clamp for logs of probabilities that are positive by
# construction.
TINY = 1e-30


class VerifyResult(NamedTuple):
    tokens: torch.Tensor        # [gamma+1] int64
    n_matches: torch.Tensor     # int64 scalar: accepted draft tokens
    draft_index: torch.Tensor   # int64 scalar: which draft row was committed
    rounds: torch.Tensor        # int64 scalar: multidraft rounds executed


class Telemetry(NamedTuple):
    """Per-block acceptance telemetry (the reference's return_probs
    channel): one row per multidraft round; rows of rounds that did not run
    stay zero (VerifyResult.rounds says how many ran)."""

    step_back_probs: torch.Tensor  # [K, gamma] float32
    p_i: torch.Tensor              # [K, gamma] float32
    q_i: torch.Tensor              # [K, gamma] float32


def telemetry_zeros(K: int, gamma: int, device) -> Telemetry:
    return Telemetry(*(torch.zeros((K, gamma), dtype=torch.float32,
                                   device=device) for _ in range(3)))


def gather_token_probs(dist: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """dist: [T, V], tokens: [T] -> probs [T]."""
    return torch.gather(dist, -1, tokens[:, None])[:, 0]


def categorical(probs: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Gumbel-max index of an (unnormalized, nonnegative) probability vector;
    the log clamps at 0, as `common.categorical` does."""
    return torch.argmax(torch.log(torch.clamp(probs, min=0.0)) + noise, dim=-1)


def normalize(probs: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    """probs / sum(probs); `fallback` where the mass is zero."""
    s = torch.sum(probs, dim=-1, keepdim=True)
    ok = s > 0
    return torch.where(ok, probs / torch.where(ok, s, torch.ones_like(s)),
                       fallback)


def prefix_matches(draft_tokens: torch.Tensor, b, ind: torch.Tensor,
                   n: torch.Tensor) -> torch.Tensor:
    """True iff draft b's first n tokens equal draft ind's first n tokens.
    b is an int (the parallel layout's round) or a 0-d tensor (the striped
    layout's data-dependent row); either indexes on the device."""
    gamma = draft_tokens.shape[1]
    pos = torch.arange(gamma, device=draft_tokens.device)
    same = draft_tokens[b] == draft_tokens[ind]
    return torch.all(torch.where(pos < n, same, True))


def window_index(m: torch.Tensor, gamma: int):
    """Row indices and validity mask of the window [m, gamma)."""
    rel = torch.arange(gamma, device=m.device)
    idx = torch.clamp(m + rel, 0, gamma - 1)
    valid = rel < gamma - m
    return idx, valid


def last_true_index(flags: torch.Tensor) -> torch.Tensor:
    """Index of the last True in a 1-D bool tensor; 0 if none."""
    n = flags.shape[0]
    last = n - 1 - torch.argmax(torch.flip(flags, [0]).to(torch.int32))
    return torch.where(torch.any(flags), last, torch.zeros_like(last))


def scatter_commit(draft_row: torch.Tensor, extra_token: torch.Tensor,
                   n_matches: torch.Tensor) -> torch.Tensor:
    """Committed tokens: draft_row[:n] + [extra] (+ zero padding)."""
    gamma = draft_row.shape[0]
    pos = torch.arange(gamma + 1, device=draft_row.device)
    padded = torch.cat([draft_row, draft_row.new_zeros(1)])
    return torch.where(pos < n_matches, padded,
                       torch.where(pos == n_matches, extra_token,
                                   torch.zeros_like(padded)))


def scalar(value, dtype, device) -> torch.Tensor:
    """A 0-d tensor made by a fill on the device (no host-to-device copy,
    which would wait for the device)."""
    return torch.full((), value, dtype=dtype, device=device)
