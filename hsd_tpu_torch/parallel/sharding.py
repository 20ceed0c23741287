"""Partition specs for model weights and KV caches, and each rank's shard
of them (port of `hsd_tpu/parallel/sharding.py`).

A spec is the JAX `PartitionSpec` as a tuple: one entry per dim, an axis
name or None. `shard_tree(tree, specs, mesh)` returns THIS rank's local
slice of every leaf: dim d with axis a keeps the rank's equal chunk
[i * n / size, (i + 1) * n / size) of it, i the rank's index on a.

The layout is Megatron's over the `model` axis (`param_specs`):
  * wq / wk / wv and wgate / wup on their out-features (heads, ffn);
    wo and wdown on their in-features; biases with their columns;
  * the head on its out-features (vocab shards; the forwards gather the
    logits); the embedding on its vocab rows;
  * MoE stacks [L, E, in, out]: the expert axis (expert_parallel) or
    every expert's ffn (not);
  * KV caches on the kv-head axis (`cache_specs`): append and rollback
    stay local;
  * norms and the router replicated.
Quantized weights shard their codes and their group scales / zeros by the
same rule (the group axis follows the in-features).

Packed int4 on the in axis. The codes of a packed weight are split-half:
byte row j holds logical rows j and j + in/2 (`ops.linear.pack_int4`). A
chunk of the PACKED rows therefore holds two separated runs of logical
rows, while the rank's activation shard and its scale groups are one
contiguous run. (The JAX package's shard_map layout, `tp.tp_param_specs`
through `_linear_spec`, shards exactly so, and its TP forward on a packed
int4 wo / wdown disagrees with its single-device forward by more than the
logits' own size; GSPMD, which keeps the global meaning, does not.) Here
an in-sharded packed weight is unpacked, sliced on its logical rows and
packed again, split-half within the shard, with its scales / zeros on the
matching groups: the shard is the quantized image of the rank's rows.

An act-order permutation (`perm`) on an in-sharded weight must map the
shard's stored rows to the shard's own input features, and is then
re-indexed to them; otherwise the shard would gather the local activation
with global indices, and `shard_tree` raises.

The GSPMD layout. PyTorch has no partitioner that splits a program around
a ctypes kernel (nor does DTensor, which is therefore not used), so the
GSPMD layout of `param_specs` runs through the same explicit-collective
forward as the shard_map layout of `tp.tp_param_specs`
(`transformer.forward(tp_axis=...)`, through the forwards of parallel/tp.py):
a vocab-sharded embedding is looked up on the rank's rows, masked and
psummed, and the vocab-sharded logits are gathered. `replicate` is the
identity: every rank holds its own copy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..config import ModelConfig
from ..engine.kvcache import (KVCache, init_cache, put_rows, rollback,
                              select_draft_row, select_rows)
from ..models.transformer import ModelParams, QuantizedEmbedding
from ..ops.linear import QuantizedLinear
from .mesh import MODEL_AXIS, Mesh


def _linear_spec(w: Any, in_spec, out_spec, stacked: bool, lead=()):
    """The spec of a dense weight or a QuantizedLinear (a QuantizedLinear
    of specs). stacked prepends the layer axis (replicated); `lead` adds
    further leading axes (the MoE expert axis) after it. A perm is
    replicated (its own leading axes included)."""
    lead = ((None,) if stacked else ()) + tuple(lead)
    if isinstance(w, QuantizedLinear):
        return QuantizedLinear(
            qweight=(*lead, in_spec, out_spec),
            scales=(*lead, in_spec, out_spec),
            zeros=None if w.zeros is None else (*lead, in_spec, out_spec),
            perm=None if w.perm is None else (None,) * w.perm.dim())
    return (*lead, in_spec, out_spec)


def _is_expert_stacked(w: Any) -> bool:
    arr = w.qweight if isinstance(w, QuantizedLinear) else w
    return arr.dim() == 4


def _embed_spec(embed, axis):
    if isinstance(embed, QuantizedEmbedding):
        return QuantizedEmbedding(codes=(axis, None), scale=(axis,))
    return (axis, None)


def param_specs(params: ModelParams,
                expert_parallel: bool = False) -> ModelParams:
    """ModelParams-shaped tree of specs (Megatron TP layout, the JAX
    `param_specs`): the embedding vocab-sharded; MoE stacks on the expert
    axis with expert_parallel, else on every expert's ffn."""
    specs = {}
    for name, w in params.layers.items():
        if name in ("ln1", "ln2"):
            specs[name] = (None, None)
        elif name == "gate":
            specs[name] = (None, None, None)
        elif name in ("wgate", "wup") and _is_expert_stacked(w):
            specs[name] = (_linear_spec(w, None, None, True, (MODEL_AXIS,))
                           if expert_parallel else
                           _linear_spec(w, None, MODEL_AXIS, True, (None,)))
        elif name == "wdown" and _is_expert_stacked(w):
            specs[name] = (_linear_spec(w, None, None, True, (MODEL_AXIS,))
                           if expert_parallel else
                           _linear_spec(w, MODEL_AXIS, None, True, (None,)))
        elif name in ("wq", "wk", "wv", "wgate", "wup"):
            specs[name] = _linear_spec(w, None, MODEL_AXIS, stacked=True)
        elif name in ("wo", "wdown"):
            specs[name] = _linear_spec(w, MODEL_AXIS, None, stacked=True)
        elif name in ("bq", "bk", "bv"):
            specs[name] = (None, MODEL_AXIS)
        else:
            specs[name] = (None, None)
    lm = None
    if params.lm_head is not None:
        lm = _linear_spec(params.lm_head, None, MODEL_AXIS, stacked=False)
    return ModelParams(embed=_embed_spec(params.embed, MODEL_AXIS),
                       layers=specs, final_norm=(None,), lm_head=lm)


def cache_specs() -> KVCache:
    """KVCache specs: [L, B, S, H_kv, D] with the kv heads on `model`."""
    return KVCache(k=(None, None, None, MODEL_AXIS, None),
                   v=(None, None, None, MODEL_AXIS, None),
                   length=(), start=(None,))


def _chunk(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of x under spec: a contiguous copy with storage of
    its own when a dim is split (a view, even a contiguous one on dim 0,
    would keep the whole tensor alive after the caller drops it)."""
    if spec is None or x is None:
        return x
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} for a tensor of shape "
                         f"{tuple(x.shape)}")
    sliced = False
    for d, name in enumerate(spec):
        if name is None:
            continue
        ax = mesh[name]
        n = x.shape[d]
        if n % ax.size:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"over {ax.size} ranks of {name!r}")
        x = x.narrow(d, ax.index * (n // ax.size), n // ax.size)
        sliced = True
    if sliced:
        return x.clone(memory_format=torch.contiguous_format)
    return x.contiguous()


def _packed_rows(q: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """Logical rows [lo, lo + n) of split-half packed codes q [in/2, out],
    packed again split-half: uint8 [n/2, out]. Logical row r is the low
    nibble of byte row r below in/2, else the high nibble of row r - in/2;
    the nibbles (code + 8) move as they are."""
    half = q.shape[0]
    hi_end = lo + n
    parts = []
    if lo < half:
        parts.append(q[lo:min(hi_end, half)] & 0xF)
    if hi_end > half:
        parts.append(q[max(lo, half) - half:hi_end - half] >> 4)
    nib = torch.cat(parts, 0)
    m = n // 2
    return nib[:m] | (nib[m:] << 4)


def _shard_packed(q: torch.Tensor, ax) -> torch.Tensor:
    """This rank's in-shard of packed codes [..., in/2, out], one matrix at
    a time (a whole stack unpacked at once would need 4x its bytes)."""
    din = 2 * q.shape[-2]
    n = din // ax.size
    if din % ax.size or n % 2:
        raise ValueError(f"{din} packed rows do not split into even shards "
                         f"over {ax.size} ranks")
    flat = q.reshape(-1, *q.shape[-2:])
    out = torch.stack([_packed_rows(m, ax.index * n, n) for m in flat])
    return out.reshape(*q.shape[:-2], n // 2, q.shape[-1])


def _local_perm(perm: torch.Tensor, ax, din: int) -> torch.Tensor:
    """The shard's perm: stored rows [i * n, (i + 1) * n) of an in-sharded
    weight, which must read input features of the same range."""
    n = din // ax.size
    lo = ax.index * n
    p = perm.narrow(-1, lo, n) - lo
    if bool(((p < 0) | (p >= n)).any()):
        raise ValueError("an in-sharded act-order weight needs a perm local "
                         "to each shard: the shard's stored rows read "
                         "features of other ranks")
    return p


def _shard_linear(w: QuantizedLinear, spec: QuantizedLinear,
                  mesh: Mesh) -> QuantizedLinear:
    in_name = spec.qweight[-2]
    perm = w.perm
    if in_name is not None and perm is not None:
        perm = _local_perm(perm, mesh[in_name], w.din)
    if in_name is not None and w.packed_int4:
        # slice the LOGICAL rows and pack again within the shard
        out_spec = (None,) * (w.qweight.dim() - 2) + (None, spec.qweight[-1])
        lead = tuple(spec.qweight[:-2]) + (None, None)
        qweight = _chunk(w.qweight, lead, mesh)
        qweight = _chunk(_shard_packed(qweight, mesh[in_name]), out_spec,
                         mesh)
    else:
        qweight = _chunk(w.qweight, spec.qweight, mesh)
    return QuantizedLinear(
        qweight=qweight, scales=_chunk(w.scales, spec.scales, mesh),
        zeros=_chunk(w.zeros, spec.zeros, mesh),
        perm=None if perm is None else perm.contiguous())


def shard_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """This rank's local slice of every leaf of `tree` under the matching
    spec tree (ModelParams, dicts, QuantizedLinear, QuantizedEmbedding,
    KVCache or a tensor). An in-sharded packed-int4 QuantizedLinear is
    unpacked, sliced and packed again (module docstring)."""
    if tree is None:
        return None
    if isinstance(tree, QuantizedLinear):
        return _shard_linear(tree, specs, mesh)
    if isinstance(tree, KVCache):
        return tree.replace(k=_chunk(tree.k, specs.k, mesh),
                            v=_chunk(tree.v, specs.v, mesh),
                            start=_chunk(tree.start, specs.start, mesh))
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(shard_tree(getattr(tree, f), getattr(specs, f),
                                       mesh) for f in tree._fields))
    return _chunk(tree, specs, mesh)


def shard_params(params: ModelParams, mesh: Mesh,
                 expert_parallel: bool = False) -> ModelParams:
    return shard_tree(params, param_specs(params, expert_parallel), mesh)


def replicate(tree: Any, mesh: Optional[Mesh] = None) -> Any:
    """Every rank holds the whole tree: the identity."""
    return tree


def local_config(cfg: ModelConfig, tp: int = 1, pp: int = 1) -> ModelConfig:
    """The config a rank's KV cache is built from: Hkv / tp kv heads (the
    head size pinned) and L / pp layers."""
    if cfg.num_kv_heads % tp or cfg.num_layers % pp:
        raise ValueError(f"{cfg.num_kv_heads} kv heads / {cfg.num_layers} "
                         f"layers do not split over tp={tp}, pp={pp}")
    return dataclasses.replace(
        cfg, num_kv_heads=cfg.num_kv_heads // tp,
        num_heads=cfg.num_heads // tp, head_dim=cfg.head_dim_,
        num_layers=cfg.num_layers // pp)


def cache_ops(cfg_local: ModelConfig):
    """make_generate's `target_cache_ops` (init, rollback, select) for a
    target whose cache is a rank's local one (`local_config`)."""
    def init(batch, max_len, start, device):
        return init_cache(cfg_local, batch, max_len, device).replace(
            start=start)
    return init, rollback, select_draft_row


def pool_cache_ops(cfg_local: ModelConfig):
    """SlotPool / SlotEngine's `target_cache_ops` (init, put, select) for a
    rank's local cache."""
    init, _, _ = cache_ops(cfg_local)
    return init, put_rows, select_rows


def cache_init(cfg_local: ModelConfig):
    """The EAGLE engines' `target_cache_init(batch, max_len, device)` for a
    rank's local cache."""
    return lambda batch, max_len, device: init_cache(cfg_local, batch,
                                                     max_len, device)

