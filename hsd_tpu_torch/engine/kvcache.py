"""Static preallocated KV cache with O(1) speculative rollback (port of
`hsd_tpu/engine/kvcache.py`).

  * buffers are fixed [L, B, S_max, H_kv, D] tensors; `length` is a host
    int — the number of valid positions, uniform over the batch;
  * append writes IN PLACE at `length` (the JAX package returns new arrays;
    here the buffers are mutated and the returned cache shares them);
  * rollback sets `length` lower: stale slots are dead because attention
    masks by index and later appends overwrite them;
  * multidraft row-select copies one batch row over the others, in place.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import ModelConfig


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor        # [L, B, S_max, H_kv, D]
    v: torch.Tensor        # [L, B, S_max, H_kv, D]
    length: int            # valid positions (uniform over the batch)
    start: torch.Tensor    # int64 [B]: slots [0, start) are dead left-pad

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def batch(self) -> int:
        return self.k.shape[1]

    def replace(self, **kw) -> "KVCache":
        return dataclasses.replace(self, **kw)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=None) -> KVCache:
    dtype = dtype or cfg.dtype
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0,
                   start=torch.zeros((batch,), dtype=torch.int64,
                                     device=device))


def append_layer_stacked(k_all: torch.Tensor, v_all: torch.Tensor, idx: int,
                         length: int, k_new: torch.Tensor,
                         v_new: torch.Tensor):
    """Write k_new/v_new [B, T, H_kv, D] into layer `idx` of the stacked cache
    at positions [length, length+T), in place."""
    T = k_new.shape[1]
    k_all[idx, :, length:length + T] = k_new.to(k_all.dtype)
    v_all[idx, :, length:length + T] = v_new.to(v_all.dtype)
    return k_all, v_all


def rollback(cache: KVCache, new_length: int) -> KVCache:
    """Speculative rollback: truncate to `new_length` valid positions. O(1)."""
    return cache.replace(length=int(new_length))


def select_draft_row(cache: KVCache, row: int) -> KVCache:
    """Multidraft rollback: keep draft `row`'s KV (and start) in every batch
    slot, in place."""
    cache.k[:] = cache.k[:, row:row + 1].clone()
    cache.v[:] = cache.v[:, row:row + 1].clone()
    cache.start[:] = cache.start[row].clone()
    return cache
