"""Pipeline parallelism: a layer-sharded target over a `pipe` axis (port of
`hsd_tpu/parallel/pp.py`).

The reference spreads its big targets over GPUs by LAYER
(`manual_device_map`, chain-of-thought-hub/gsm8k/
eval_speculative_decoding_llm.py:204-277). Here the layer-stacked weights
and the layer-stacked KV cache shard on their layer axis over `pipe`:
rank s holds layers [s * L/pp, (s + 1) * L/pp) and their cache, and one
forward runs the stages in turn:
  * every rank embeds the tokens (only stage 0's hidden is read);
  * at stage s, rank s runs its layers (`transformer.forward(hidden_in=...,
    skip_head=True)` on its local [L/pp] slice, local layer indices), then
    broadcasts the hidden to every rank of the axis: the hand-off to stage
    s + 1 and, after the last stage, the JAX code's masked-psum broadcast
    of the final hidden, in one exact copy;
  * every rank applies the final norm and the replicated head.
The stages run the single-card layers, the fused layout included, so K1
and K2 run under PP, and the logits are those of the single-card forward
bit for bit. PP x TP runs the stages' layers Megatron-sharded over a
`model` axis of the same grid (`make_pp_tp_mesh`), the head on its vocab
shards, the logits gathered.
"""
from __future__ import annotations

from typing import Optional

from ..config import ModelConfig
from ..models import transformer
from ..models.transformer import ModelParams, QuantizedEmbedding
from ..ops.linear import QuantizedLinear, apply_linear, rms_norm
from .mesh import MODEL_AXIS, Axis, Mesh, all_gather, broadcast_from, make_grid
from .sharding import cache_ops, local_config, pool_cache_ops, shard_tree

PIPE_AXIS = "pipe"


def make_pp_mesh(pp: int) -> Mesh:
    return make_grid((pp,), (PIPE_AXIS,))


def _lead_pipe(w):
    """Spec with the layer axis on `pipe` (a per-layer perm too; a perm
    shared by every layer stays whole)."""
    def spec(a):
        return (PIPE_AXIS,) + (None,) * (a.dim() - 1)
    if isinstance(w, QuantizedLinear):
        stacked_perm = (w.perm is not None
                        and w.perm.dim() == w.qweight.dim() - 1)
        return QuantizedLinear(
            qweight=spec(w.qweight), scales=spec(w.scales),
            zeros=None if w.zeros is None else spec(w.zeros),
            perm=None if w.perm is None else
            (spec(w.perm) if stacked_perm else (None,) * w.perm.dim()))
    return spec(w)


def _replicated(w):
    if w is None:
        return None
    if isinstance(w, QuantizedLinear):
        return QuantizedLinear(*(None if t is None else (None,) * t.dim()
                                 for t in w))
    if isinstance(w, QuantizedEmbedding):
        return QuantizedEmbedding(codes=(None, None), scale=(None,))
    return (None,) * w.dim()


def pp_param_specs(params: ModelParams) -> ModelParams:
    """Layer stacks on the LAYER axis; embedding, norm and head
    replicated."""
    return ModelParams(
        embed=_replicated(params.embed),
        layers={k: _lead_pipe(v) for k, v in params.layers.items()},
        final_norm=(None,), lm_head=_replicated(params.lm_head))


def pp_cache_specs():
    from ..engine.kvcache import KVCache
    return KVCache(k=(PIPE_AXIS, None, None, None, None),
                   v=(PIPE_AXIS, None, None, None, None),
                   length=(), start=(None,))


def shard_params_pp(params: ModelParams, mesh: Mesh) -> ModelParams:
    return shard_tree(params, pp_param_specs(params), mesh)


def pp_cache_ops(cfg: ModelConfig, mesh: Mesh):
    """make_generate's target_cache_ops for a stage's layers."""
    return cache_ops(local_config(cfg, tp=_tp(mesh), pp=mesh[PIPE_AXIS].size))


def pp_pool_cache_ops(cfg: ModelConfig, mesh: Mesh):
    """SlotPool / SlotEngine's target_cache_ops for a stage's layers."""
    return pool_cache_ops(local_config(cfg, pp=mesh[PIPE_AXIS].size))


def _tp(mesh: Mesh) -> int:
    return mesh[MODEL_AXIS].size if MODEL_AXIS in mesh.axes else 1


def _pp_stage_body(cfg: ModelConfig, pipe: Axis, p: ModelParams, tokens,
                   cache, tp_axis: Optional[Axis] = None,
                   skip_head: bool = False, **kw):
    """One rank's view of the pipelined forward: embed, the stages in turn
    (this rank's at its own), the hidden broadcast after each, then the
    final norm and the head (vocab-sharded under tp_axis) on every rank.
    kw: transformer.forward's per-row arguments (lengths, slots)."""
    h = transformer._embed(cfg, p.embed, tokens)
    for stage in range(pipe.size):
        if pipe.index == stage:
            h, cache = transformer.forward(cfg, p, tokens, cache,
                                           hidden_in=h, skip_head=True,
                                           tp_axis=tp_axis, **kw)
        h = broadcast_from(h.contiguous(), pipe, stage)
    if skip_head:
        return h, cache
    x = rms_norm(h, p.final_norm, cfg.rms_norm_eps)
    head = p.embed.t() if p.lm_head is None else p.lm_head
    logits = apply_linear(head, x, mxu_bf16=cfg.gptq_mxu_bf16,
                          slots=kw.get("slots", 1)).float()
    return logits, cache


def make_pp_target_forward(cfg: ModelConfig, params: ModelParams,
                           mesh: Mesh):
    """make_generate's target_forward `(params, tokens, cache,
    skip_head=False) -> (logits, cache)` over the `pipe` axis (pair it with
    `pp_cache_ops`). pp must divide cfg.num_layers."""
    pipe = mesh[PIPE_AXIS]
    if cfg.num_layers % pipe.size:
        raise ValueError(f"{cfg.num_layers} layers over pp={pipe.size}")

    def fwd(p, tokens, cache, skip_head=False):
        return _pp_stage_body(cfg, pipe, p, tokens, cache,
                              skip_head=skip_head)

    return fwd


def make_pp_server_forward(cfg: ModelConfig, params: ModelParams,
                           mesh: Mesh, rows_per_slot: int = 1):
    """SlotPool's flattened-rows target forward `(params, tokens [N, T],
    cache, lengths, skip_head=False)` over the `pipe` axis (pair it with
    `pp_pool_cache_ops`); rows_per_slot as `tp.make_tp_server_forward`."""
    pipe = mesh[PIPE_AXIS]
    if cfg.num_layers % pipe.size:
        raise ValueError(f"{cfg.num_layers} layers over pp={pipe.size}")

    def fwd(p, tokens, cache, lengths, skip_head=False):
        return _pp_stage_body(cfg, pipe, p, tokens, cache,
                              skip_head=skip_head, lengths=lengths,
                              slots=tokens.shape[0] // rows_per_slot)

    return fwd


# ---------------------------------------------------------------------------
# PP x TP: pipe stages of Megatron-sharded layers (e.g. pp 2 x tp 4 on 8
# cards: per-card weight bytes = layers / pp * shard / tp)
# ---------------------------------------------------------------------------

def make_pp_tp_mesh(pp: int, tp: int) -> Mesh:
    return make_grid((pp, tp), (PIPE_AXIS, MODEL_AXIS))


def pp_tp_param_specs(params: ModelParams) -> ModelParams:
    """tp_param_specs with the layer (leading) axis on `pipe` too."""
    from .tp import tp_param_specs

    def add_pipe(spec):
        if spec is None:
            return None
        if isinstance(spec, QuantizedLinear):
            return QuantizedLinear(*(add_pipe(s) for s in spec))
        return (PIPE_AXIS,) + tuple(spec[1:])

    tps = tp_param_specs(params)
    layers = {}
    for k, v in tps.layers.items():
        w = params.layers[k]
        if isinstance(w, QuantizedLinear) and w.perm is not None \
                and w.perm.dim() != w.qweight.dim() - 1:
            # a perm shared by every layer stays whole
            layers[k] = add_pipe(v)._replace(perm=v.perm)
        else:
            layers[k] = add_pipe(v)
    return ModelParams(embed=tps.embed, layers=layers,
                       final_norm=tps.final_norm, lm_head=tps.lm_head)


def pp_tp_cache_specs():
    from ..engine.kvcache import KVCache
    return KVCache(k=(PIPE_AXIS, None, None, MODEL_AXIS, None),
                   v=(PIPE_AXIS, None, None, MODEL_AXIS, None),
                   length=(), start=(None,))


def shard_params_pp_tp(params: ModelParams, mesh: Mesh) -> ModelParams:
    return shard_tree(params, pp_tp_param_specs(params), mesh)


def make_pp_tp_target_forward(cfg: ModelConfig, params: ModelParams,
                              mesh: Mesh):
    """Pipe stages whose layers run Megatron-sharded over `model` (pair it
    with `pp_cache_ops`, which sizes the cache for both axes); the logits
    gathered over the vocab."""
    pipe, model = mesh[PIPE_AXIS], mesh[MODEL_AXIS]
    if cfg.num_layers % pipe.size:
        raise ValueError(f"{cfg.num_layers} layers over pp={pipe.size}")
    if params.lm_head is None:
        raise ValueError("PP x TP needs an untied lm_head (vocab shards)")

    def fwd(p, tokens, cache, skip_head=False):
        out, cache = _pp_stage_body(cfg, pipe, p, tokens, cache,
                                    tp_axis=model, skip_head=skip_head)
        return (out if skip_head else all_gather(out, model)), cache

    return fwd
