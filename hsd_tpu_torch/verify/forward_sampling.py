"""Forward-sampling verification step (port of
`hsd_tpu/verify/forward_sampling.py`), used by the stepwise engine's inner
steps: over the accumulated draft, resample the frontier token from the
joint divergence norm(max(Jp_prev * p_last - Jq_prev * q_last, 0)) (in the
scale-free log form of verify/hsd.py); the drafted token survives only when
the resample lands on it, with a bonus draw from p on the last step.

Noise bundle: {"gumbel": [V], "gumbel_bonus": [V]} — the JAX package draws
them at fold_in(key, 0) and fold_in(key, 1).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.sampling import gumbel
from .common import TINY, categorical


def forward_sampling_noise(V: int, generator: Optional[torch.Generator],
                           device) -> dict:
    return {"gumbel": gumbel((V,), generator, device),
            "gumbel_bonus": gumbel((V,), generator, device)}


def forward_sampling_step(cand_tokens: torch.Tensor, q: torch.Tensor,
                          p: torch.Tensor, cand_len: int,
                          last_step: bool = False,
                          noise: Optional[dict] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cand_tokens [L] (valid prefix cand_len, a host int); q, p [L, V] rows
    aligned with the tokens (p may carry an extra bonus row). Returns
    (tokens [2], n): tokens[0] the resampled token; when last_step and it
    equals the drafted frontier token, tokens[1] is the bonus draw and
    n = 1, else n = 0 and tokens[1] = tokens[0]."""
    L = cand_tokens.shape[0]
    V = q.shape[-1]
    dev = q.device
    if noise is None:
        noise = forward_sampling_noise(V, generator, dev)
    valid = torch.arange(L, device=dev) < cand_len
    xc = torch.clamp(cand_tokens, 0, V - 1)
    q_i = torch.where(valid, torch.gather(q[:L], 1, xc[:, None])[:, 0], 1.0)
    p_i = torch.where(valid, torch.gather(p[:L], 1, xc[:, None])[:, 0], 1.0)
    log_jq = torch.cumsum(torch.log(torch.clamp(q_i, min=TINY)), 0)
    log_jp = torch.cumsum(torch.where(
        p_i > 0, torch.log(torch.clamp(p_i, min=TINY)), float("-inf")), 0)
    last = min(max(cand_len - 1, 0), L - 1)
    prev = min(max(last - 1, 0), L - 1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    log_jp_prev = log_jp[prev] if cand_len > 1 else zero
    log_jq_prev = log_jq[prev] if cand_len > 1 else zero
    r = torch.exp(torch.clamp(log_jp_prev - log_jq_prev, max=80.0))
    diffs = r * p[last] - q[last]
    plus = torch.clamp(diffs, min=0.0)
    denom = torch.maximum(torch.sum(plus), torch.sum(torch.clamp(-diffs,
                                                                 min=0.0)))
    resid = torch.where(denom > 0, plus / torch.clamp(denom, min=TINY),
                        p[last])
    rs = torch.sum(resid)
    resid = torch.where(rs > 0, resid / torch.clamp(rs, min=TINY), p[last])
    t = categorical(resid, noise["gumbel"])
    accept = (t == cand_tokens[last]) & last_step
    bonus_row = min(max(cand_len, 0), p.shape[0] - 1)
    b = categorical(p[bonus_row], noise["gumbel_bonus"])
    return torch.stack([t, torch.where(accept, b, t)]), accept.long()
