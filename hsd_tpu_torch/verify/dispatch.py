"""Single entry point for the verifiers (port of `hsd_tpu/verify/dispatch.py`)."""
from __future__ import annotations

import functools
from typing import Optional

import torch

from .blockwise import verify_blockwise, verify_greedy
from .hsd import verify_hsd
from .tokenwise import verify_tokenwise

_METHODS = {
    "tokenwise": verify_tokenwise,
    "blockwise": verify_blockwise,
    # exact HSD (capped frontier)
    "hsd": verify_hsd,
    # the committed reference's raw-joint frontier
    "hsd_ref": functools.partial(verify_hsd, frontier="raw"),
    "greedy": verify_greedy,
}


def verify(method: str, draft_tokens: torch.Tensor, q: torch.Tensor,
           p: torch.Tensor, noise: Optional[dict] = None,
           generator: Optional[torch.Generator] = None,
           num_drafts: int = 0):
    """Verify drafts of gamma tokens; see verify/common.py for the contract.

    method: 'tokenwise' | 'blockwise' | 'hsd' | 'hsd_ref' | 'greedy'.
    num_drafts: K verification rounds (defaults to the row count).
    """
    return _METHODS[method](draft_tokens, q, p, noise=noise,
                            generator=generator, num_drafts=num_drafts)
