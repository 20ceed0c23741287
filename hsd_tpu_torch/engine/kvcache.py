"""Static preallocated KV cache with O(1) speculative rollback (port of
`hsd_tpu/engine/kvcache.py`).

  * buffers are fixed [L, B, S_max, H_kv, D] tensors; `length` is a host
    int — the number of valid positions, uniform over the batch;
  * append writes IN PLACE at `length` (the JAX package returns new arrays;
    here the buffers are mutated and the returned cache shares them);
  * rollback sets `length` lower: stale slots are dead because attention
    masks by index and later appends overwrite them;
  * multidraft row-select copies one batch row over the others, in place;
  * the slot pools keep per-row frontiers beside the cache (a [B] device
    tensor), since their rows commit different token counts: the
    speculative pool (`speculative.SlotPool`) appends each row at its own
    frontier (`append_layer_stacked_ragged`), rolls back by setting the
    frontiers (`slot_frontiers`) and keeps each slot's winning row
    (`select_rows`); the EAGLE pool's tree forward writes at a fixed
    staging tail and `compact_path_staged` moves each row's accepted path
    to its frontier, in place on the stacked buffers.
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


def append_layer_stacked_ragged(k_all: torch.Tensor, v_all: torch.Tensor,
                                idx: int, lengths: torch.Tensor,
                                k_new: torch.Tensor, v_new: torch.Tensor):
    """Per-row append into layer `idx` of the stacked cache, in place: row b
    writes k_new[b] / v_new[b] [T, H_kv, D] at positions [lengths[b],
    lengths[b] + T), one indexed write per buffer. Every position must lie
    inside the buffer: PyTorch raises on (the card faults on) an
    out-of-range index where JAX drops the write, so the caller keeps each
    row's frontier at most S - T."""
    B, T = k_new.shape[:2]
    dev = k_all.device
    b_ids = torch.arange(B, device=dev)[:, None].expand(B, T)
    pos = lengths[:, None] + torch.arange(T, device=dev)[None, :]
    k_all[idx, b_ids, pos] = k_new.to(k_all.dtype)
    v_all[idx, b_ids, pos] = v_new.to(v_all.dtype)
    return k_all, v_all


def compact_path(cache: KVCache, rel_indices: torch.Tensor, n_valid: int,
                 base: int) -> KVCache:
    """Tree-path KV compaction for one frontier `base` (a host int): gather
    slots base + rel_indices[j] (fixed size, -1 padded) into contiguous
    [base, base + T) and set length = base + n_valid. Slots past n_valid
    receive junk from clipped gathers, dead by the length contract. The
    write start is clipped so the T slots fit, as dynamic_update_slice
    clips it."""
    T = rel_indices.shape[0]
    S = cache.max_len
    src = base + torch.clamp(rel_indices, 0, S - 1)
    src = torch.clamp(src, max=S - 1)
    kg = cache.k.index_select(2, src)
    vg = cache.v.index_select(2, src)
    b0 = min(max(base, 0), S - T)
    cache.k[:, :, b0:b0 + T] = kg
    cache.v[:, :, b0:b0 + T] = vg
    return cache.replace(length=int(base + n_valid))


def _gather_seq(buf: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """buf [L, B, S, H, D], src [B, T] -> buf[:, b, src[b, t]] [L, B, T, H, D]."""
    L, B, S, H, D = buf.shape
    T = src.shape[1]
    return torch.gather(buf, 2, src[None, :, :, None, None].expand(
        L, B, T, H, D))


def compact_path_staged(cache: KVCache, rel_indices: torch.Tensor,
                        n_valid: torch.Tensor, dst_base: torch.Tensor,
                        src_base: int) -> KVCache:
    """Staged tree-path compaction: row b copies staging entries src_base +
    rel_indices[b] (the fixed region the batched tree forward wrote,
    transformer.forward staging_at) to its own frontier [dst_base[b],
    dst_base[b] + T), in place. A destination outside [0, src_base) is
    dropped, as JAX's scatter drops it: such an entry is written back onto
    its own source slot with the value it read there, which changes
    nothing and needs no host sync (sources lie in the staging region,
    destinations below it, so the two never overlap)."""
    B, T = rel_indices.shape
    S = cache.max_len
    dev = cache.k.device
    src = src_base + torch.clamp(rel_indices, 0, S - 1 - src_base)
    kg, vg = _gather_seq(cache.k, src), _gather_seq(cache.v, src)
    b_ids = torch.arange(B, device=dev)[:, None].expand(B, T)
    dst = dst_base[:, None] + torch.arange(T, device=dev)[None, :]
    dst = torch.where((dst >= 0) & (dst < src_base), dst, src)
    cache.k[:, b_ids, dst] = kg
    cache.v[:, b_ids, dst] = vg
    return cache


def rollback(cache: KVCache, new_length: int) -> KVCache:
    """Speculative rollback: truncate to `new_length` valid positions. O(1)."""
    return cache.replace(length=int(new_length))


# the committed length of an empty slot (the JAX server's, server.py:419)
EMPTY_LENGTH = 2


def live_length(length: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """[SLOTS] the committed length a pool block runs each slot at: its own
    if it is live, else an empty slot's, so that a slot frozen at its
    final length (up to S - 2) computes rows that nothing reads without
    writing past the buffer (JAX drops such writes; PyTorch raises)."""
    return torch.where(live, length, torch.full_like(length, EMPTY_LENGTH))


def slot_frontiers(at: torch.Tensor, offset: int, rows: int) -> torch.Tensor:
    """Per-slot rollback: the cache frontier of each of a slot's `rows` rows,
    [SLOTS * rows], slot-major: the slot's committed length `at`
    (`live_length`) less `offset` (the draft holds committed-2 positions,
    the target committed-1)."""
    return (at - offset).repeat_interleave(rows)


def winning_rows(draft_index: torch.Tensor, rows: int) -> torch.Tensor:
    """[SLOTS * rows] source row of every cache row once each slot s keeps
    its winning row s * rows + draft_index[s]."""
    base = torch.arange(draft_index.shape[0], device=draft_index.device)
    return (base * rows + draft_index).repeat_interleave(rows)


def put_rows(pool: KVCache, rows: slice, cache: KVCache) -> KVCache:
    """Copy a request's cache (all its rows and positions, and its starts)
    into rows `rows` of a pool's cache, in place: a slot's admission."""
    pool.k[:, rows] = cache.k
    pool.v[:, rows] = cache.v
    pool.start[rows] = cache.start
    return pool


def select_rows(cache: KVCache, src: torch.Tensor) -> KVCache:
    """Per-slot multidraft select, in place: row b takes row src[b]'s KV and
    start (src from `winning_rows`), the slot-batched form of
    `select_draft_row`."""
    cache.k[:] = cache.k.index_select(1, src)
    cache.v[:] = cache.v.index_select(1, src)
    cache.start[:] = cache.start.index_select(0, src)
    return cache


def select_draft_row(cache: KVCache, row: int) -> KVCache:
    """Multidraft rollback: keep draft `row`'s KV (and start) in every batch
    slot, in place."""
    cache.k[:] = cache.k[:, row:row + 1].clone()
    cache.v[:] = cache.v[:, row:row + 1].clone()
    cache.start[:] = cache.start[row].clone()
    return cache
