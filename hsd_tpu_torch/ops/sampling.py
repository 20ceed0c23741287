"""Sampling and logits processing with explicit noise.

The port of `hsd_tpu/ops/sampling.py`. A categorical draw is Gumbel-max,
`argmax(log p + g)`, as `jax.random.categorical` computes it, so a test that
hands both sides the same Gumbel vector gets the same token. Without given
noise the draw comes from a `torch.Generator`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def process_logits(logits: torch.Tensor, temperature: float = 1.0,
                   top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Probabilities after temperature / top-k / top-p. temperature 0 is
    greedy: a one-hot of the argmax."""
    if temperature == 0.0:
        return F.one_hot(torch.argmax(logits, dim=-1),
                         logits.shape[-1]).to(torch.float32)
    logits = logits.float() / temperature
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens whose prefix mass (exclusive) is < top_p
        keep_sorted = (cum - probs) < top_p
        kth = torch.amax(torch.where(keep_sorted, sorted_logits,
                                     float("-inf")), dim=-1, keepdim=True)
        logits = torch.where(logits < kth, float("-inf"), logits)
    return torch.softmax(logits, dim=-1)


def processor(temperature: float, top_k: int = 0, top_p: float = 1.0):
    """Closure form of process_logits."""
    def proc(logits: torch.Tensor) -> torch.Tensor:
        return process_logits(logits, temperature, top_k, top_p)
    return proc


def gumbel(shape, generator: Optional[torch.Generator],
           device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1)."""
    return gumbel_of(torch.rand(shape, generator=generator, device=device,
                                dtype=torch.float32))


def gumbel_of(u: torch.Tensor) -> torch.Tensor:
    """`gumbel`'s transform of drawn uniforms, elementwise."""
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def uniform(shape, generator: Optional[torch.Generator],
            device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32)


def sample(probs: torch.Tensor, generator: Optional[torch.Generator] = None,
           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Categorical sample over the last axis of a probability array.
    noise: Gumbel noise of probs' shape, else drawn from `generator`."""
    if noise is None:
        noise = gumbel(probs.shape, generator, probs.device)
    return torch.argmax(torch.log(torch.clamp(probs, min=1e-38)) + noise,
                        dim=-1)
