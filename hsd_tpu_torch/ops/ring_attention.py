"""Ring attention: exact causal attention over a sequence-sharded axis
(port of `hsd_tpu/ops/ring_attention.py`).

The token axis of a long prompt is split over the ranks of an `sp` axis;
each rank holds its query chunk while the K/V blocks travel the ring
(`mesh.ppermute`, sp - 1 hops), each block with its global positions, and
f32 online-softmax accumulators are renormalized by the running row max as
each block arrives. Causality is by GLOBAL positions (q_pos >= k_pos), so
ragged chunks need nothing more. GQA is the grouped product over
[kv_head, rep]: repeated K/V is never materialized.

XLA compiles this in the reference, so it is plain PyTorch here, not a
kernel, and has no launch counter.
"""
from __future__ import annotations

import torch

from ..parallel.mesh import Axis, axis_size, ppermute


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, axis: Axis) -> torch.Tensor:
    """q: [B, Tc, H, d] local query chunk; k, v: [B, Tc, Hkv, d] the local
    K/V chunk; q_pos: [B, Tc] the GLOBAL positions of the local queries
    (the local keys have the same). Returns [B, Tc, H, d] in f32. Every
    rank of `axis` calls it with its own chunk."""
    B, Tc, H, d = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    sp = axis_size(axis)
    qg = (q.float() * (d ** -0.5)).reshape(B, Tc, Hkv, rep, d)

    acc = torch.zeros((B, Tc, Hkv, rep, d), dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, Tc, Hkv, rep), float("-inf"), dtype=torch.float32,
                   device=q.device)
    den = torch.zeros((B, Tc, Hkv, rep), dtype=torch.float32, device=q.device)

    ring = [(i, (i + 1) % sp) for i in range(sp)]
    blk = (k.float(), v.float(), q_pos)
    for step in range(sp):
        kb, vb, pb = blk
        scores = torch.einsum("btkrd,bskd->btkrs", qg, kb)
        mask = q_pos[:, :, None] >= pb[:, None, :]               # [B, Tc, Tc']
        scores = torch.where(mask[:, :, None, None, :], scores, -1e30)
        new_m = torch.maximum(m, torch.amax(scores, -1))
        scale_old = torch.exp(m - new_m)
        p = torch.exp(scores - new_m[..., None])
        # a row with every key masked so far keeps its max at -inf
        p = torch.where(torch.isfinite(new_m)[..., None], p, 0.0)
        scale_old = torch.where(torch.isfinite(m), scale_old, 0.0)
        acc = acc * scale_old[..., None] + torch.einsum(
            "btkrs,bskd->btkrd", p, vb)
        den = den * scale_old + torch.sum(p, -1)
        m = new_m
        if step < sp - 1:
            blk = ppermute(blk, axis, ring)

    out = acc / torch.clamp(den[..., None], min=1e-30)
    return out.reshape(B, Tc, H, d)
