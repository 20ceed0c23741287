"""Flash-decode attention (K8): online-softmax GQA over the static KV cache.

The port of `hsd_tpu/ops/flash_decode.py`. One query row block of a single
sequence attends to the whole cache buffer of one layer: the index mask
(`key_pos <= q_index`, `>= start`), an optional [T, T] additive bias on the
slots [kv_length, kv_length + T) (tree attention), and an optional
rotate-half RoPE applied to the raw queries inside the kernel. A fully
masked query row gives zeros, where the einsum path gives the mean of V.

Routing is the JAX package's opt-in and nothing else: `FLASH_DECODE` and
`FUSED_ATTN` are read at import from the same environment variables
(`HSD_TPU_FLASH_DECODE`, `HSD_TPU_FUSED_ATTN`), so one setting routes both
packages alike; tests and scripts set the module attributes. Under "auto"
nothing is routed here.

On a CUDA tensor `flash_decode` launches `csrc/flash_decode.cu` or raises;
on a CPU tensor it runs the plain version, `flash_core_plain`.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from . import _build
from .gptq_cuda import _check

NEG = -1e30
BLOCK_S = 512          # the Pallas kernel's S block (the plain version's)

FLASH_DECODE = os.environ.get("HSD_TPU_FLASH_DECODE", "auto")
FUSED_ATTN = os.environ.get("HSD_TPU_FUSED_ATTN", "auto")


def use_fused_rope_attn(B: int, T: int, d: int, S: int) -> bool:
    """Route a decode layer to the RoPE-fused kernel: only under
    FUSED_ATTN="always" (and not FLASH_DECODE="always"), for one row,
    T <= 16, head_dim 64/128 and a cache of at least 128 slots."""
    if FUSED_ATTN != "always" or FLASH_DECODE == "always":
        return False
    return B == 1 and T <= 16 and d in (64, 128) and S >= 128


def use_flash(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Route attention to the kernel: only under FLASH_DECODE="always", for
    q [B, T, H, d] with B == 1, T <= 128, d in {64, 128} against a cache
    buffer k [B, S, Hkv, d] of at least 128 slots."""
    if FLASH_DECODE != "always":
        return False
    d = q.shape[-1]
    return (q.shape[1] <= 128 and d in (64, 128) and k.shape[3] == d
            and k.shape[1] >= 128 and q.shape[0] == 1)


# --------------------------------------------------------------------------
# the plain version: the Pallas kernel's arithmetic, S block by S block

def rope_rotate(qf: torch.Tensor, rope) -> torch.Tensor:
    """Rotate-half RoPE of f32 queries [T, H, d] with the side-by-side tables
    (cos2, sin2) [T, d] of models/transformer.rope_tables: the products of
    rope_apply, left in f32."""
    cos2, sin2 = rope
    x1, x2 = torch.chunk(qf, 2, dim=-1)
    return qf * cos2[:, None] + torch.cat([x2, x1], -1) * sin2[:, None]


def flash_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_index: torch.Tensor, start, kv_length: int,
                     attn_bias: Optional[torch.Tensor] = None,
                     rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     block_s: int = BLOCK_S) -> torch.Tensor:
    """One sequence: q [T, H, d]; k, v [S, Hkv, d]; q_index [T]; start a
    0-d or [1] tensor; kv_length an int; attn_bias [T, T] or None; rope the
    tables (cos2, sin2) [T, d] or None (then q is already rotated).
    Returns [T, H, d] float32.

    As `_flash_core`: per S block of `block_s`, f32 scores times d**-0.5,
    the bias, the index mask, online-softmax rescaling with an explicit
    zero at invalid keys, p cast to V's dtype for PV with f32
    accumulation, and acc / max(l, 1e-30) at the end."""
    T, H, d = q.shape
    S, Hkv = k.shape[0], k.shape[1]
    rep = H // Hkv
    dev = q.device
    qf = q.float()
    if rope is not None:
        qf = rope_rotate(qf, (rope[0].float(), rope[1].float()))
    qg = qf.reshape(T, Hkv, rep, d).permute(1, 2, 0, 3)        # [Hkv, rep, T, d]
    kp = torch.arange(S, device=dev)
    valid_all = ((kp[None, :] <= q_index.reshape(T, 1))
                 & (kp[None, :] >= start.reshape(())))          # [T, S]
    bias_all = None
    if attn_bias is not None:
        bias_all = torch.zeros((T, S), dtype=torch.float32, device=dev)
        hi = min(S, kv_length + T)
        if hi > kv_length:
            bias_all[:, kv_length:hi] = attn_bias.float().reshape(T, T)[
                :, :hi - kv_length]
    m = torch.full((Hkv, rep, T, 1), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((Hkv, rep, T, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((Hkv, rep, T, d), dtype=torch.float32, device=dev)
    scale = d ** -0.5
    Sb = min(block_s, S)
    for s0 in range(0, S, Sb):
        kb = k[s0:s0 + Sb].float()                                # [Sb, Hkv, d]
        vb = v[s0:s0 + Sb]
        scores = torch.einsum("hrtd,shd->hrts", qg, kb) * scale
        if bias_all is not None:
            scores = scores + bias_all[:, s0:s0 + Sb]
        valid = valid_all[:, s0:s0 + Sb]
        scores = torch.where(valid, scores, NEG)
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(scores - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = torch.einsum("hrts,shd->hrtd", p.to(v.dtype).float(), vb.float())
        acc = acc * alpha + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(2, 0, 1, 3).reshape(T, H, d)


# --------------------------------------------------------------------------
# K8 — replaces flash_decode._kernel (hsd_tpu/ops/flash_decode.py:49, the
# pallas_call at :166). Bound: the K and V bytes of the S cache slots, read
# once (14B at S = 4192: 2 x 4192 x 8 x 128 x 2 bytes = 17.2 MB, ~5.1 us at
# 3.35 TB/s). Batch 1 gives only Hkv kv heads, so S is split into chunks
# fixed by (S, Hkv, d) alone. bf16 K/V take one launch of the tensor-core
# kernel (csrc/flash_decode.cu: mma.sync over a cp.async ring of K/V tiles,
# each chunk read once per 64 query rows, the chunks of a kv head one
# cluster that combines them in order); f32 K/V the CUDA-core pair of
# launches. A query row's bits do not depend on T or on the row count, and
# no atomics are used.

_DTYPES = (torch.float32, torch.bfloat16)
KEY_TILE = 64           # csrc/flash_decode.cu kTileKeys
MAX_CHUNKS = 16         # csrc/flash_decode.cu kMaxChunks: the largest cluster
# Clusters of the bf16 kernel (one block an SM) that an H100 SXM holds at
# once, by cluster size 1..16 (cudaOccupancyMaxActiveClusters)
RESIDENT_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7)


def chunk_for(S: int, Hkv: int, d: int) -> int:
    """Keys per S chunk: a multiple of the 64-key tile, with as many chunks
    as the largest cluster of which the card holds Hkv at once (one cluster
    a kv head; 9 at Hkv = 8, 16 at Hkv <= 7). Both head widths d run one
    block an SM, so they share the table. Depends on S, Hkv and d only,
    never on T or the row count."""
    n = max((c for c, r in enumerate(RESIDENT_CLUSTERS, 1) if r >= Hkv),
            default=1)
    return KEY_TILE * -(-S // (KEY_TILE * n))


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_index: torch.Tensor, start: torch.Tensor, kv_length: int,
                 attn_bias: Optional[torch.Tensor] = None,
                 rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """One sequence's attention, [T, H, d] in q.dtype (see flash_core_plain
    for the arguments). On the card q may be a row-strided view (heads
    contiguous); k and v are one layer's cache buffers [S, Hkv, d] of q's
    dtype; q_index [T] and start [1] are int64 device tensors, read by the
    kernel (no host sync)."""
    if not q.is_cuda:
        return flash_core_plain(q, k, v, q_index, start, kv_length,
                                attn_bias, rope).to(q.dtype)
    T, H, d = q.shape
    S, Hkv = k.shape[0], k.shape[1]
    if d not in (64, 128) or H % Hkv or tuple(k.shape) != (S, Hkv, d):
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} not supported")
    if q.dtype not in _DTYPES or q.stride(2) != 1 or q.stride(1) != d:
        raise ValueError("q: f32/bf16 with contiguous heads")
    _check(k, "k", (q.dtype,))
    _check(v, "v", (q.dtype,), k.shape)
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k, v: must start 16-byte aligned")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and (q.data_ptr() % 16 or q.stride(0) % 8):
        raise ValueError("q: bf16 rows must start 16-byte aligned")
    _check(q_index, "q_index", (torch.int64,), (T,))
    start = start.reshape(-1)[:1]
    _check(start, "start", (torch.int64,))
    if attn_bias is not None:
        attn_bias = attn_bias.reshape(T, T)
        _check(attn_bias, "attn_bias", (torch.float32,))
    cos2 = sin2 = None
    if rope is not None:
        cos2, sin2 = (r.reshape(T, d) for r in rope)
        _check(cos2, "cos2", (torch.float32,))
        _check(sin2, "sin2", (torch.float32,))
        if bf16 and (cos2.data_ptr() % 16 or sin2.data_ptr() % 16):
            raise ValueError("cos2, sin2: must start 16-byte aligned")
    rT = (H // Hkv) * T
    chunk = chunk_for(S, Hkv, d)
    n_chunks = -(-S // chunk)
    dev = q.device
    # f32: one allocation for the accumulators and the (max, denominator)
    # pairs; bf16 combines the chunks on chip
    ws = (None if bf16 else
          torch.empty(n_chunks * Hkv * rT * (d + 2), dtype=torch.float32,
                      device=dev))
    out = torch.empty((T, H, d), dtype=q.dtype, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.lib("flash_decode")
    err = lib.hsd_flash_decode(
        ptr(q), q.stride(0), ptr(k), ptr(v), int(bf16), ptr(q_index),
        ptr(start), int(kv_length), ptr(attn_bias), ptr(cos2), ptr(sin2), T,
        H, Hkv, d, S, chunk, d ** -0.5, ptr(ws), ptr(out),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash-decode kernel (T={T}, H={H}, Hkv={Hkv}, "
                           f"d={d}, S={S}): "
                           f"{lib.hsd_flash_error_string(err).decode()}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
WRAPPERS = {"K8": flash_decode}


def flash_attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_index: torch.Tensor, kv_length: int,
                           start: torch.Tensor,
                           attn_bias: Optional[torch.Tensor] = None,
                           rope=None) -> torch.Tensor:
    """The decode route of models/transformer, for one row (the gates admit
    B == 1 only): q [1, T, H, d]; k, v [1, S, Hkv, d] (one layer's cache
    buffers); q_index [1, T]; kv_length an int; start [1]; attn_bias
    [T, T] or [1, T, T] or None; rope the tables (cos2, sin2) [1, T, 1, d]
    of transformer.rope_tables, in which case q arrives raw. Returns
    [1, T, H, d] in q.dtype."""
    if q.shape[0] != 1:
        raise ValueError(f"flash-decode takes one row, got {q.shape[0]}")
    bias = None if attn_bias is None else attn_bias.float().reshape(
        q.shape[1], q.shape[1]).contiguous()
    rope = None if rope is None else (rope[0][0, :, 0], rope[1][0, :, 0])
    return flash_decode(q[0], k[0], v[0], q_index[0], start, kv_length, bias,
                        rope)[None]
