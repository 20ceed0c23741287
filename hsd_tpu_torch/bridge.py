"""Carry the JAX package's parameters and caches into the port.

Structures are read by attribute (duck typing), so this module imports
nothing from the JAX package: anything with `qweight/scales/zeros/perm` is a
QuantizedLinear, `codes/scale` a QuantizedEmbedding, `embed/layers/
final_norm/lm_head` a ModelParams and `k/v/length/start` a KVCache. Arrays
cross as numpy (`np.asarray` of a JAX array); bf16 crosses as a uint16 view,
because `torch.from_numpy` cannot read ml_dtypes' bfloat16. Layouts are kept
exactly: split-half nibbles, scales [groups, out], zeros or None, perm.
MoE layers cross the same way: the f32 router `gate` [L, D, E] and the
expert stacks, dense [L, E, in, out] or QuantizedLinear with every field
(perm [L, E, in] included) on the [L, E] axes.

The EAGLE structures (EagleParams, CoupledEagleParams, EagleKV, Trie) of
the JAX package hold one slot; the port's carry a leading slot axis, so
EagleKV and Trie gain a batch of one on the way across. Integer index
arrays become int64.

An optax `TrainState` of the EAGLE trainers (`chain(clip_by_global_norm,
adamw)`: opt_state[1][0] holds Adam's count, mu and nu) crosses into the
port's `train.eagle3.TrainState`: the params, AdamW's moments and the
count, which sets the scheduler's position and the step.
"""
from __future__ import annotations

import numpy as np
import torch

from .engine.kvcache import KVCache
from .eval.synthetic import CoupledEagleParams
from .models.eagle import EagleKV, EagleParams, Trie
from .models.transformer import ModelParams, QuantizedEmbedding
from .ops.linear import QuantizedLinear
from .train.eagle3 import (TrainConfig, TrainState, init_train_state,
                           lr_lambda, trainable_leaves)


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


def eagle_params_from_jax(params, device="cpu") -> EagleParams:
    """A JAX `EagleParams` of either head version -> the port's (d2t as
    int64); matmul fields quantized by `quantize_eagle_params` cross as
    QuantizedLinear, fc_b stays None for a v3 head."""
    fields = {f: convert(getattr(params, f), device)
              for f in EagleParams._fields}
    fields["d2t"] = fields["d2t"].long()
    return EagleParams(**fields)


def coupled_eagle_from_jax(cp, device="cpu") -> CoupledEagleParams:
    """A JAX `CoupledEagleParams` -> the port's (scale and lam as floats)."""
    return CoupledEagleParams(
        big=params_from_jax(cp.big, device), embed=convert(cp.embed, device),
        fc_e=convert(cp.fc_e, device), lm_head=convert(cp.lm_head, device),
        scale=float(np.asarray(cp.scale)), lam=float(np.asarray(cp.lam)))


def eagle_kv_from_jax(kv, device="cpu") -> EagleKV:
    """A one-slot JAX `EagleKV` ([1, S, H, D], scalar length and start) ->
    the port's, with length and start as [1] int64."""
    scalar = lambda a: to_torch(a, device).long().reshape(1)
    return EagleKV(k=to_torch(kv.k, device), v=to_torch(kv.v, device),
                   length=scalar(kv.length), start=scalar(kv.start))


def trie_from_jax(trie, device="cpu") -> Trie:
    """A one-slot JAX `Trie` -> the port's, with a leading batch of one."""
    return Trie(*(to_torch(getattr(trie, f), device)[None]
                  .to(torch.bool if f == "tree_mask" else torch.int64)
                  for f in Trie._fields))


def train_state_from_jax(state, tc: TrainConfig, device="cpu") -> TrainState:
    """A JAX `train.eagle3.TrainState` -> the port's: the head's params, then
    each trainable leaf's Adam mu / nu as AdamW's exp_avg / exp_avg_sq at
    the optax count, the scheduler and the optimizer's lr at that count,
    and the step. A run resumed from it continues where the JAX one was."""
    out = init_train_state(eagle_params_from_jax(state.params, device), tc)
    adam = state.opt_state[1][0]
    count = int(np.asarray(adam.count))
    for name, p in trainable_leaves(out.params):
        out.opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": to_torch(adam.mu[name], device),
            "exp_avg_sq": to_torch(adam.nu[name], device)}
    lr = tc.lr * lr_lambda(tc)(count)
    for g in out.opt.param_groups:
        g["lr"] = lr
    out.sched.load_state_dict(dict(out.sched.state_dict(), last_epoch=count,
                                   _last_lr=[lr]))
    out.step = int(np.asarray(state.step))
    return out
