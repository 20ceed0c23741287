"""Megatron tensor parallelism with the kernels on local shards (port of
`hsd_tpu/parallel/tp.py`).

Every rank of the `model` axis runs the same single-card forward, its
quantized products through `apply_linear`'s routes on the rank's Megatron
shard, with the collectives `transformer.forward(tp_axis=...)` issues: a
psum after wo and after wdown (in the activation dtype), and an f32 psum of
the MoE expert mix. A shard shape that no kernel takes goes to
`xla_matmul`, as in JAX. The layout must be unfused (`unfuse_params`
splits a fused one), so K1 and K2 do not run under TP.

Shard layout (`tp_param_specs`): q/k/v and gate/up on their out-features,
wo and wdown on their in-features (packed int4 re-packed within the shard,
parallel/sharding.py), MoE stacks on the expert axis, the head on its
vocab columns; the embedding, norms, router and biases on replicated
activations replicated (the biases with their columns); the KV cache on
its kv heads, so append and rollback stay local.

Logits. The JAX forwards return the logits vocab-sharded and let GSPMD
gather the rows the verifier reads. Here every rank runs the whole engine
loop itself, so each forward below all-gathers the logits (one collective)
and every rank verifies on the same full rows: with the generators seeded
alike, every rank commits the same tokens. The forwards take either
layout: `shard_params_tp`'s, or `sharding.shard_params`'s (the GSPMD
layout, its embedding vocab-sharded). A tied head is the embedding's
transpose: vocab-sharded logits under the GSPMD layout (gathered), whole
ones under the replicated embedding of `tp_param_specs` (the JAX package
asserts an untied head there; here each rank then computes the whole
head, and nothing is gathered). The engines' `target_forward`
protocols are unchanged; a rank's cache is its local one, which the
engines build through `target_cache_ops` / `target_cache_init`
(`tp_cache_ops`, `tp_pool_cache_ops`, `tp_cache_init`).
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..config import ModelConfig
from ..models import transformer
from ..models.transformer import ModelParams, QuantizedEmbedding
from ..ops.linear import QuantizedLinear
from .mesh import MODEL_AXIS, Mesh, all_gather
from .sharding import (_is_expert_stacked, _linear_spec, cache_init,
                       cache_ops, local_config, pool_cache_ops, shard_tree)


def tp_param_specs(params: ModelParams) -> ModelParams:
    """Specs of the shard_map TP layout: `sharding.param_specs` but with
    the embedding REPLICATED (the lookup is local) and MoE stacks always on
    the expert axis."""
    specs = {}
    for name, w in params.layers.items():
        if name in ("ln1", "ln2"):
            specs[name] = (None, None)
        elif name == "gate":
            specs[name] = (None, None, None)
        elif name in ("wgate", "wup", "wdown") and _is_expert_stacked(w):
            specs[name] = _linear_spec(w, None, None, True, (MODEL_AXIS,))
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
    embed = (QuantizedEmbedding(codes=(None, None), scale=(None,))
             if isinstance(params.embed, QuantizedEmbedding)
             else (None, None))
    return ModelParams(embed=embed, layers=specs, final_norm=(None,),
                       lm_head=lm)


def shard_params_tp(params: ModelParams, mesh: Mesh) -> ModelParams:
    """This rank's shard of `params` in the TP layout."""
    return shard_tree(params, tp_param_specs(params), mesh)


def unfuse_params(cfg: ModelConfig, params: ModelParams) -> ModelParams:
    """Split a fused layout (`transformer.fuse_params`, or
    `eval.synthetic.init_quantized_params`) into the unfused one TP needs:
    wqkv -> wq / wk / wv, wgu -> wgate / wup, bqkv -> bq / bk / bv, on
    their out-columns (packed int4 packs along rows, so its columns, with
    their scales and zeros, slice cleanly)."""
    L = dict(params.layers)
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_

    def cols(w, a, b):
        if isinstance(w, QuantizedLinear):
            return QuantizedLinear(
                qweight=w.qweight[..., a:b].contiguous(),
                scales=w.scales[..., a:b].contiguous(),
                zeros=None if w.zeros is None
                else w.zeros[..., a:b].contiguous(), perm=w.perm)
        return w[..., a:b].contiguous()

    q, kv = H * hd, Hkv * hd
    if "wqkv" in L:
        w = L.pop("wqkv")
        L.update(wq=cols(w, 0, q), wk=cols(w, q, q + kv),
                 wv=cols(w, q + kv, q + 2 * kv))
    if "bqkv" in L:
        b = L.pop("bqkv")
        L.update(bq=cols(b, 0, q), bk=cols(b, q, q + kv),
                 bv=cols(b, q + kv, q + 2 * kv))
    if "wgu" in L:
        w = L.pop("wgu")
        F = cfg.intermediate_size
        L.update(wgate=cols(w, 0, F), wup=cols(w, F, 2 * F))
    return params._replace(layers=L)


def _check(params: ModelParams):
    if "wqkv" in params.layers or "wgu" in params.layers:
        raise ValueError("TP runs keep the unfused layout (unfuse_params)")


def _gather(cfg: ModelConfig, logits, axis):
    """The full-vocabulary logits: vocab shards gathered (whole ones, from
    a tied head over a replicated embedding, as they are)."""
    if logits.shape[-1] == cfg.vocab_size:
        return logits
    return all_gather(logits, axis)


def tp_cache_ops(cfg: ModelConfig, mesh: Mesh):
    """make_generate's target_cache_ops for a rank's kv-head shard."""
    return cache_ops(local_config(cfg, tp=mesh[MODEL_AXIS].size))


def tp_pool_cache_ops(cfg: ModelConfig, mesh: Mesh):
    """SlotPool / SlotEngine's target_cache_ops for a rank's shard."""
    return pool_cache_ops(local_config(cfg, tp=mesh[MODEL_AXIS].size))


def tp_cache_init(cfg: ModelConfig, mesh: Mesh):
    """The EAGLE engines' target_cache_init for a rank's shard."""
    return cache_init(local_config(cfg, tp=mesh[MODEL_AXIS].size))


def make_tp_target_forward(cfg: ModelConfig, params: ModelParams,
                           mesh: Mesh):
    """`fwd(params, tokens, cache, skip_head=False) -> (logits, cache)` on
    this rank's shards, the logits gathered over the vocab (make_generate's
    target_forward; pair it with `tp_cache_ops`)."""
    _check(params)
    axis = mesh[MODEL_AXIS]

    def fwd(p, tokens, cache, skip_head=False):
        out, cache = transformer.forward(cfg, p, tokens, cache,
                                         skip_head=skip_head, tp_axis=axis)
        return (out if skip_head else _gather(cfg, out, axis)), cache

    return fwd


def make_tp_server_forward(cfg: ModelConfig, params: ModelParams,
                           mesh: Mesh, rows_per_slot: int = 1):
    """SlotPool's flattened-rows target forward `(params, tokens [N, T],
    cache, lengths, skip_head=False) -> (logits, cache)` on this rank's
    shards (pair it with `tp_pool_cache_ops`). rows_per_slot: the
    verifier's rows R, so each product routes on one slot's rows as the
    default forward routes them (the JAX forward maps the slots)."""
    _check(params)
    axis = mesh[MODEL_AXIS]

    def fwd(p, tokens, cache, lengths, skip_head=False):
        out, cache = transformer.forward(
            cfg, p, tokens, cache, lengths=lengths, skip_head=skip_head,
            slots=tokens.shape[0] // rows_per_slot, tp_axis=axis)
        return (out if skip_head else _gather(cfg, out, axis)), cache

    return fwd


def make_tp_eagle_forward(cfg: ModelConfig, params: ModelParams,
                          feature_layers: Tuple[int, ...], mesh: Mesh):
    """The EAGLE engines' target forward `(params, tokens, cache,
    attn_bias, positions, lengths=None, staging_at=None, last_only=False)
    -> (logits, cache, feats)` on this rank's shards: the tree bias and the
    positions replicated, the feature stream replicated (it feeds the
    replicated head), the logits gathered. Both forms of the JAX package's
    pool forward (5 arguments for the admission prefill, 6 with per-row
    frontiers and the staging region) are this one function."""
    _check(params)
    axis = mesh[MODEL_AXIS]

    def fwd(p, tokens, cache, attn_bias, positions, lengths=None,
            staging_at=None, last_only=False):
        logits, cache, feats = transformer.forward(
            cfg, p, tokens, cache, attn_bias=attn_bias, positions=positions,
            feature_layers=feature_layers, lengths=lengths,
            staging_at=staging_at, last_only=last_only, tp_axis=axis)
        return _gather(cfg, logits, axis), cache, feats

    return fwd


make_tp_eagle_pool_forward = make_tp_eagle_forward


def make_tp_forward(cfg: ModelConfig, params: ModelParams, mesh: Mesh,
                    feature_layers: Optional[Tuple[int, ...]] = None,
                    with_bias: bool = False):
    """`fwd(params, tokens, cache[, attn_bias])` on this rank's shards:
    (logits, cache) or, with feature_layers, (logits, cache, feats); the
    logits gathered over the vocab."""
    _check(params)
    axis = mesh[MODEL_AXIS]

    def run(p, tokens, cache, attn_bias=None):
        out = transformer.forward(cfg, p, tokens, cache, attn_bias=attn_bias,
                                  feature_layers=feature_layers,
                                  tp_axis=axis)
        return (_gather(cfg, out[0], axis),) + tuple(out[1:])

    if with_bias:
        return lambda p, tokens, cache, attn_bias: run(p, tokens, cache,
                                                       attn_bias)
    return lambda p, tokens, cache: run(p, tokens, cache)
