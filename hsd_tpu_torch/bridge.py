"""Carry the JAX package's parameters and caches into the port.

Structures are read by attribute (duck typing), so this module imports
nothing from the JAX package: anything with `qweight/scales/zeros/perm` is a
QuantizedLinear, `codes/scale` a QuantizedEmbedding, `embed/layers/
final_norm/lm_head` a ModelParams and `k/v/length/start` a KVCache. Arrays
cross as numpy (`np.asarray` of a JAX array); bf16 crosses as a uint16 view,
because `torch.from_numpy` cannot read ml_dtypes' bfloat16. Layouts are kept
exactly: split-half nibbles, scales [groups, out], zeros or None, perm.
"""
from __future__ import annotations

import numpy as np
import torch

from .engine.kvcache import KVCache
from .models.transformer import ModelParams, QuantizedEmbedding
from .ops.linear import QuantizedLinear


def to_torch(a, device="cpu") -> torch.Tensor:
    """One array -> tensor with the same dtype and values."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device)


def _opt(a, device):
    return None if a is None else to_torch(a, device)


def convert(obj, device="cpu"):
    """Convert a parameter leaf or structure: QuantizedLinear,
    QuantizedEmbedding, dict, None or an array."""
    if obj is None:
        return None
    if hasattr(obj, "qweight"):
        perm = _opt(getattr(obj, "perm", None), device)
        return QuantizedLinear(
            qweight=to_torch(obj.qweight, device),
            scales=to_torch(obj.scales, device),
            zeros=_opt(obj.zeros, device),
            perm=None if perm is None else perm.long())
    if hasattr(obj, "codes") and hasattr(obj, "scale"):
        return QuantizedEmbedding(codes=to_torch(obj.codes, device),
                                  scale=to_torch(obj.scale, device))
    if isinstance(obj, dict):
        return {k: convert(v, device) for k, v in obj.items()}
    return to_torch(obj, device)


def params_from_jax(params, device="cpu") -> ModelParams:
    """A JAX `ModelParams` -> the port's ModelParams."""
    return ModelParams(embed=convert(params.embed, device),
                       layers=convert(dict(params.layers), device),
                       final_norm=convert(params.final_norm, device),
                       lm_head=convert(params.lm_head, device))


def cache_from_jax(cache, device="cpu") -> KVCache:
    """A JAX `KVCache` -> the port's KVCache (length becomes a host int)."""
    return KVCache(k=to_torch(cache.k, device), v=to_torch(cache.v, device),
                   length=int(np.asarray(cache.length)),
                   start=to_torch(cache.start, device).long())
