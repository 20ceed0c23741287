"""Plain Hierarchical Speculative Decoding verification of one draft (K 1),
the capped frontier, in float64: the decision that the served block has to
have made from its own draft, draft law q, target law p and noise.

  q [gamma, V], p [gamma + 1, V], draft [gamma]; noise u [gamma], u2, and a
  Gumbel vector g [V] for the last token.

With r_j the capped joint ratio before position j (the running product of
p / q, over its running maximum above 1), the step-back probability at j
is 1 - sum (r_j p_j - q_j)+ / max(sum (r_j p_j - q_j)+, sum (q_j - r_j
p_j)+); the block stops after the last position whose uniform is at least
its step-back probability, unless log u2 <= the capped log ratio of the
whole draft, which accepts it all. The last token is drawn by Gumbel-max
from the bonus row p[gamma] (all accepted) or the normalized residual
(r p - q)+ at the stop, falling back to the draft's token there.

`margin` is the smallest distance of any of these decisions from its
threshold; a disagreement within a rounding of it is a tie, not a fault.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

TINY = 1e-30


class Decision(NamedTuple):
    n: int               # accepted draft tokens
    tokens: list         # the committed tokens: draft[:n] + [last]
    margin: float


def _log(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, torch.log(x.clamp(min=TINY)),
                       torch.full_like(x, float("-inf")))


def hsd(draft, q, p, u, u2, g) -> Decision:
    draft = draft.long().cpu()
    q, p = q.double().cpu(), p.double().cpu()
    u, g = u.double().cpu(), g.double().cpu()
    u2 = float(u2)
    gamma = draft.shape[0]
    pos = torch.arange(gamma)
    qi = q[pos, draft]
    pi = p[pos, draft]
    lq = torch.log(qi.clamp(min=TINY))
    lp = _log(pi)
    zero = torch.zeros(1, dtype=torch.float64)
    ljq = torch.cat([zero, torch.cumsum(lq, 0)[:-1]])
    ljp = torch.cat([zero, torch.cumsum(lp, 0)[:-1]])
    cap = torch.cummax((ljp - ljq).clamp(min=0.0), 0).values
    r = torch.exp(ljp - cap - ljq)
    diff = r[:, None] * p[:gamma] - q
    plus = diff.clamp(min=0.0)
    s_plus, s_minus = plus.sum(-1), (-diff).clamp(min=0.0).sum(-1)
    denom = torch.maximum(s_plus, s_minus)
    sbp = torch.where(denom > 0, 1.0 - s_plus / denom.clamp(min=TINY),
                      torch.zeros_like(denom)).clamp(0.0, 1.0)
    keep = u >= sbp
    stop = int(torch.nonzero(keep).max()) if bool(keep.any()) else 0
    log_joint = float((ljp - cap - ljq + lp - lq)[gamma - 1])
    lu2 = float(torch.log(torch.tensor(max(u2, TINY), dtype=torch.float64)))
    n = gamma if lu2 <= log_joint else stop
    margin = min(float((u - sbp).abs().min()),
                 abs(lu2 - log_joint) if log_joint > float("-inf") else 1.0)
    if n == gamma:
        dist = p[gamma]
    else:
        resid = plus[n]
        s = float(resid.sum())
        dist = resid / s if s > 0 else torch.nn.functional.one_hot(
            draft[n], q.shape[-1]).double()
    score = _log(dist) + g
    top = torch.topk(score, 2).values
    margin = min(margin, float(top[0] - top[1]))
    last = int(torch.argmax(score))
    return Decision(n, draft[:n].tolist() + [last], margin)
