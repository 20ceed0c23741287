"""Single entry point for the verifiers (port of `hsd_tpu/verify/dispatch.py`)."""
from __future__ import annotations

import functools
from typing import Optional

import torch

from .blockwise import blockwise_noise, verify_blockwise, verify_greedy
from .hsd import hsd_noise, verify_hsd
from .tokenwise import tokenwise_noise, verify_tokenwise

_METHODS = {
    "tokenwise": verify_tokenwise,
    "blockwise": verify_blockwise,
    # exact HSD (capped frontier)
    "hsd": verify_hsd,
    # the committed reference's raw-joint frontier
    "hsd_ref": functools.partial(verify_hsd, frontier="raw"),
    "greedy": verify_greedy,
}
TELEMETRY_METHODS = ("tokenwise", "hsd", "hsd_ref")
# the methods with a striped row layout (the others are single-draft)
STRIPED_METHODS = TELEMETRY_METHODS


def verify_noise(method: str, K: int, gamma: int, V: int,
                 generator: Optional[torch.Generator], device):
    """The noise bundle `verify(method, ..., generator=generator)` draws,
    drawn in the same order from the same generator (None for greedy, which
    draws nothing), so a caller can draw it beforehand and pass it as
    `noise` (under torch.func.vmap, say)."""
    if method == "greedy":
        return None
    if method == "blockwise":
        return blockwise_noise(gamma, V, generator, device)
    if method == "tokenwise":
        return tokenwise_noise(K, gamma, V, generator, device)
    return hsd_noise(K, gamma, V, generator, device)


def verify(method: str, draft_tokens: torch.Tensor, q: torch.Tensor,
           p: torch.Tensor, noise: Optional[dict] = None,
           generator: Optional[torch.Generator] = None,
           num_drafts: int = 0, return_telemetry: bool = False,
           striped: bool = False):
    """Verify drafts of gamma tokens; see verify/common.py for the contract.

    method: 'tokenwise' | 'blockwise' | 'hsd' | 'hsd_ref' | 'greedy'.
    num_drafts: K verification rounds (defaults to the row count).
    return_telemetry: (tokenwise, hsd, hsd_ref) also return the block's
    Telemetry, one row per round.
    striped: (tokenwise, hsd, hsd_ref) the striped row layout, R = 1 +
    gamma * (K - 1) rows (verify/tokenwise.py), instead of K parallel rows.
    """
    kw = dict(noise=noise, generator=generator, num_drafts=num_drafts)
    if striped:
        if method not in STRIPED_METHODS:
            raise ValueError(f"{method} has no striped layout")
        kw["striped"] = True
    if return_telemetry:
        if method not in TELEMETRY_METHODS:
            raise ValueError(f"{method} records no telemetry")
        kw["return_telemetry"] = True
    return _METHODS[method](draft_tokens, q, p, **kw)
