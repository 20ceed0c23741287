"""Sequence parallelism: ring-attention prefill over an `sp` axis (port of
`hsd_tpu/parallel/sp.py`).

A long prompt's token axis splits over the ranks of `sp`: rank i takes
tokens [i * Tc, (i + 1) * Tc). Every position-wise op (embedding, norms,
MLPs, logits) runs on the local chunk unchanged, and attention is exact
ring attention (ops/ring_attention.py): the K/V blocks travel the ring
while f32 accumulators renormalize online. The prefill's cache is
SEQUENCE-sharded (rank i holds slots [i * Tc, (i + 1) * Tc)) with
`length == T` on every rank; `gather_cache` gathers it into the replicated
layout the decode engines read.
"""
from __future__ import annotations

import torch

from ..config import ModelConfig
from ..engine.kvcache import KVCache, init_cache
from ..models import transformer
from ..models.transformer import ModelParams
from .mesh import Axis, Mesh, all_gather, make_grid

SP_AXIS = "sp"


def make_sp_mesh(sp: int) -> Mesh:
    return make_grid((sp,), (SP_AXIS,))


def make_sp_prefill(cfg: ModelConfig, mesh: Mesh):
    """`prefill(params, tokens [B, T]) -> (logits [B, T/sp, V], cache)`:
    the full prompt on every rank (T % sp == 0), of which each rank runs
    its chunk at global positions i * Tc + arange(Tc), with replicated
    params. Returns the chunk's logits and the rank's sequence shard of
    the cache, whose length is T."""
    axis = mesh[SP_AXIS]

    def prefill(p: ModelParams, tokens: torch.Tensor):
        B, T = tokens.shape
        if T % axis.size:
            raise ValueError(f"{T} tokens do not split over sp={axis.size}")
        Tc = T // axis.size
        i = axis.index
        chunk = tokens[:, i * Tc:(i + 1) * Tc]
        pos = (i * Tc + torch.arange(Tc, device=tokens.device))[None]
        cache = init_cache(cfg, B, Tc, tokens.device)
        logits, cache = transformer.forward(cfg, p, chunk, cache,
                                            positions=pos.expand(B, Tc),
                                            ring_axis=axis)
        return logits, cache.replace(length=T)

    return prefill


def gather_cache(cache: KVCache, total_slots: int, axis: Axis) -> KVCache:
    """An sp-sharded prefill cache gathered into the replicated engine
    layout with `total_slots` capacity (>= T) on every rank of `axis`."""
    k = all_gather(cache.k, axis, dim=2)
    v = all_gather(cache.v, axis, dim=2)
    L, B, T = k.shape[:3]
    if total_slots < T:
        raise ValueError(f"{total_slots} slots hold no {T}-token prefill")

    def widen(a):
        out = torch.zeros((L, B, total_slots) + a.shape[3:], dtype=a.dtype,
                          device=a.device)
        out[:, :, :T] = a
        return out

    return KVCache(k=widen(k), v=widen(v), length=cache.length,
                   start=cache.start)
