"""Unified Qwen2/Llama/Mixtral decoder in PyTorch (port of
`hsd_tpu/models/transformer.py`).

Parameters are a plain `ModelParams` with every decoder layer STACKED on a
leading [L] axis; `forward` loops over layers in Python and selects each
layer's weights as views. GQA attention with NeoX rotate-half RoPE (optional
llama3 scaling), optional qkv bias, SwiGLU MLP, RMSNorm in f32, an external
static KV cache with index-masked attention, an optional [T, T] or per-row
[B, T, T] additive attention bias, and per-matmul quantized weights
(ops/linear.py). The EAGLE engines' hooks are here too: explicit RoPE
`positions`, a feature stream (`feature_layers`), per-row cache frontiers
(`lengths`) and the staged tree block (`staging_at`). Attention logits and
softmax are f32; by default attention is plain PyTorch, as the JAX main
path computes it with an einsum. The JAX package's opt-in routes to the
flash-decode kernel (K8, ops/flash_decode.py) are kept: FLASH_DECODE=
"always" sends single-row attention there, FUSED_ATTN="always" single-row
decode steps with the RoPE of q inside the kernel.

The Mixtral family's sparse-MoE block (`_moe_ffn`) runs every expert on
every token, as the JAX package does, with the router's top-k weights
(exact zeros elsewhere) mixing them; `forward(hidden_in=...)` with
skip_head is the pipeline stage's hook (parallel/pp.py). Under tensor
parallelism (`tp_axis`, parallel/tp.py) the forward runs on one rank's
Megatron shards with the psums after wo, wdown and the expert mix; under
sequence parallelism (`ring_axis`, parallel/sp.py) attention is ring
attention over the sequence-sharded prompt.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..engine.kvcache import (KVCache, append_layer_stacked,
                              append_layer_stacked_ragged)
from ..ops import flash_decode as FD
from ..ops.linear import (QuantizedLinear, apply_attn_mlp, apply_linear,
                          apply_mlp, attn_mlp_fusable, rms_norm)


class QuantizedEmbedding(NamedTuple):
    """Per-row int8 embedding: row v dequantizes as codes[v] * scale[v]."""

    codes: torch.Tensor    # [V, D] int8
    scale: torch.Tensor    # [V] f32 or bf16


def quantize_embedding(embed: torch.Tensor) -> QuantizedEmbedding:
    w = embed.float()
    scale = torch.clamp(torch.amax(w.abs(), dim=1), min=1e-8) / 127.0
    codes = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return QuantizedEmbedding(codes=codes.to(torch.int8), scale=scale)


class ModelParams(NamedTuple):
    """Model weights. `layers` values carry a leading [L] axis."""

    embed: Any                  # [V, D] tensor or QuantizedEmbedding
    layers: Dict[str, Any]
    final_norm: torch.Tensor    # [D] f32
    lm_head: Any                # [D, V] / QuantizedLinear / None when tied


def resolve_device(device=None) -> torch.device:
    """Entry points default to the card; with none present they raise
    rather than run elsewhere. Pass device='cpu' to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run on the CPU")
    return dev


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> ModelParams:
    """Random init from a seeded torch.Generator on the target device."""
    dev = resolve_device(device)
    D, Fi, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    gen = torch.Generator(device=dev).manual_seed(seed)

    def dense(shape, scale=None):
        # shape[0] as in the JAX package: L ** -0.5 for the layer stacks
        scale = scale if scale is not None else shape[0] ** -0.5
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * scale).to(cfg.dtype)

    layers = dict(
        ln1=torch.ones((L, D), device=dev),
        ln2=torch.ones((L, D), device=dev),
        wq=dense((L, D, H * hd)),
        wk=dense((L, D, Hkv * hd)),
        wv=dense((L, D, Hkv * hd)),
        wo=dense((L, H * hd, D)),
    )
    if cfg.is_moe:
        # router [L, D, E] in f32 and per-expert SwiGLU stacks [L, E, ...]
        E = cfg.num_experts
        layers.update(
            gate=dense((L, D, E)).float(),
            wgate=dense((L, E, D, Fi), scale=D ** -0.5),
            wup=dense((L, E, D, Fi), scale=D ** -0.5),
            wdown=dense((L, E, Fi, D), scale=Fi ** -0.5))
    else:
        layers.update(wgate=dense((L, D, Fi)), wup=dense((L, D, Fi)),
                      wdown=dense((L, Fi, D)))
    if cfg.attention_bias:
        layers.update(
            bq=torch.zeros((L, H * hd), dtype=cfg.dtype, device=dev),
            bk=torch.zeros((L, Hkv * hd), dtype=cfg.dtype, device=dev),
            bv=torch.zeros((L, Hkv * hd), dtype=cfg.dtype, device=dev))
    embed = dense((cfg.vocab_size, D), scale=0.02)
    lm_head = (None if cfg.tie_word_embeddings
               else dense((D, cfg.vocab_size)))
    return ModelParams(embed=embed, layers=layers,
                       final_norm=torch.ones((D,), device=dev),
                       lm_head=lm_head)


def fuse_params(cfg: ModelConfig, params: ModelParams) -> ModelParams:
    """Fuse q|k|v and gate|up into single matmuls (out-features
    concatenated), for dense and QuantizedLinear weights alike. MoE expert
    stacks stay unfused (one product per expert)."""
    L = dict(params.layers)

    def cat(ws):
        if isinstance(ws[0], QuantizedLinear):
            perms = [w.perm for w in ws]
            if any(p is not None for p in perms) and not all(
                    p is not None and torch.equal(p, perms[0]) for p in perms):
                raise ValueError("cannot fuse desc_act projections with "
                                 "differing g_idx")
            return QuantizedLinear(
                qweight=torch.cat([w.qweight for w in ws], dim=-1),
                scales=torch.cat([w.scales for w in ws], dim=-1),
                zeros=None if ws[0].zeros is None else
                torch.cat([w.zeros for w in ws], dim=-1),
                perm=perms[0])
        return torch.cat(ws, dim=-1)

    L["wqkv"] = cat([L.pop("wq"), L.pop("wk"), L.pop("wv")])
    if "bq" in L:
        L["bqkv"] = torch.cat([L.pop("bq"), L.pop("bk"), L.pop("bv")], dim=-1)
    if "gate" not in L:
        L["wgu"] = cat([L.pop("wgate"), L.pop("wup")])
    return params._replace(layers=L)


def ordered_sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim` in one fixed order, a pairwise tree of elementwise
    adds (a zero pads an odd length, which adds exactly), so an entry's
    bits do not depend on the other dims' sizes. A reduction kernel picks
    its split by shape, and a GEMM its algorithm, so a router logit from
    either could move in its last bit with the row count, and a top-k
    decision with it."""
    t = t.movedim(dim, 0)
    while t.shape[0] > 1:
        if t.shape[0] % 2:
            t = torch.cat([t, torch.zeros_like(t[:1])])
        h = t.shape[0] // 2
        t = t[:h] + t[h:]
    return t[0]


def moe_route(cfg: ModelConfig, gate: torch.Tensor, x: torch.Tensor):
    """The router of the JAX package's `_moe_ffn` (transformer.py:172-179),
    in f32: softmax(x @ gate) over the E experts, top-k, renormalized over
    the k chosen. x: [N, D]; gate: [D, E]. Returns (logits [N, E], top_i
    [N, k], weights [N, E]: the renormalized top-k weights, zero for the
    experts not chosen). Every sum runs in `ordered_sum`'s order, so a
    row's results do not depend on the row count."""
    logits = ordered_sum(x.float()[:, :, None] * gate.float()[None], 1)
    e = torch.exp(logits - torch.amax(logits, -1, keepdim=True))
    probs = e / ordered_sum(e, 1)[:, None]
    top_w, top_i = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    top_w = top_w / ordered_sum(top_w, 1)[:, None]
    weights = torch.zeros_like(probs).scatter_(1, top_i, top_w)
    return logits, top_i, weights


def moe_params(layers: Dict[str, Any], l: int) -> Dict[str, Any]:
    """Layer l's router and expert stacks, as `_moe_ffn` takes them
    (views)."""
    lp = {"gate": layers["gate"][l]}
    for name in ("wgate", "wup", "wdown"):
        w = layers[name]
        lp[name] = w.layer(l) if isinstance(w, QuantizedLinear) else w[l]
    return lp


def _expert(w, e: int):
    return w.layer(e) if isinstance(w, QuantizedLinear) else w[e]


def _moe_ffn(cfg: ModelConfig, lp: Dict[str, Any], h: torch.Tensor,
             slots: int = 1, tp_axis=None) -> torch.Tensor:
    """Sparse-MoE SwiGLU block (Mixtral family), the JAX package's
    `_moe_ffn` (transformer.py:150-198). h: [B, T, D] -> [B, T, D]. lp: one
    layer's `gate` [D, E] and expert stacks `wgate` / `wup` [E, D, F],
    `wdown` [E, F, D] (dense, or QuantizedLinear with the [E] axis leading).

    Every expert runs on every token, as in JAX: 3 * E apply_linear calls,
    each on one expert's weight as a view, so each product routes on its
    own rows (`slots`: as forward's) and reaches the kernels; silu(g) * u
    and each expert's output in the activation dtype. The router is
    `moe_route`; the mix is f32, summed over the experts in expert order,
    rounded once to h's dtype.

    tp_axis (a parallel.mesh.Axis): the stacks are this rank's shard. With
    fewer experts than cfg.num_experts (expert parallelism) it holds experts
    [i * E_local, (i + 1) * E_local) and mixes them with those columns of
    the routing weights; with all of them it holds a slice of every
    expert's ffn (the GSPMD layout, parallel/sharding.py). Either way the
    f32 mix is a partial sum, psummed over the axis before the rounding."""
    B, T, D = h.shape
    x = h.reshape(B * T, D)
    _, _, weights = moe_route(cfg, lp["gate"], x)
    wg = lp["wgate"]
    E_local = (wg.qweight if isinstance(wg, QuantizedLinear) else wg).shape[0]
    if tp_axis is not None and E_local < cfg.num_experts:
        off = tp_axis.index * E_local
        weights = weights[:, off:off + E_local]
    y = None
    for e in range(E_local):
        g = apply_linear(_expert(lp["wgate"], e), x, slots=slots)
        u = apply_linear(_expert(lp["wup"], e), x, slots=slots)
        out = apply_linear(_expert(lp["wdown"], e), F.silu(g) * u,
                           slots=slots)
        term = weights[:, e:e + 1] * out.float()
        y = term if y is None else y + term
    if tp_axis is not None:
        from ..parallel.mesh import psum
        y = psum(y, tp_axis)
    return y.reshape(B, T, D).to(h.dtype)


def rope_tables(positions: torch.Tensor, d: int, theta: float, scaling=None):
    """Rotation tables [B, T, 1, d] for a step's positions, built once per
    forward: (cos, cos) and (-sin, sin) side by side, so that rope_apply is
    x * cos2 + rotate_half(x) * sin2. `scaling` is the llama3 (factor,
    low_freq_factor, high_freq_factor, original_max_position) tuple."""
    dev = positions.device
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=dev) / d))
    if scaling is not None:
        factor, lo_f, hi_f, orig = scaling
        wavelen = 2.0 * math.pi / freqs
        ramp = (orig / wavelen - lo_f) / (hi_f - lo_f)
        smooth = torch.clamp(ramp, 0.0, 1.0)
        freqs = (1.0 - smooth) * freqs / factor + smooth * freqs
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]
    return torch.cat([cos, cos], -1), torch.cat([-sin, sin], -1)


def rope_apply(x: torch.Tensor, tables) -> torch.Tensor:
    """NeoX rotate-half with precomputed tables. x: [B, T, H, d]. The same
    products as cat(x1 cos - x2 sin, x2 cos + x1 sin), exactly."""
    cos2, sin2 = tables
    xf = x.float()
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    return (xf * cos2 + torch.cat([x2, x1], -1) * sin2).to(x.dtype)


def attention_mask(q_index, start, S: int, T: int, kv_length,
                   attn_bias=None, staging_at=None):
    """The layer-invariant part of attention, built once per forward:
    (mask [B,1,1,T,S] bool, bias [B,1,1,T,S] f32 or None).

    Default: causal by cache index and past each row's left pad. attn_bias,
    a [T, T] or [B, T, T] additive bias, lands on the keys written this
    call, cache slots [kv_length, kv_length + T) (kv_length an int).
    staging_at (int): the T new keys sit at the fixed slots [staging_at,
    staging_at + T) of every row; a query sees its row's committed prefix
    [start, kv_length) (kv_length a per-row [B] tensor) plus that block,
    and attn_bias [B, T, T] (-inf off the ancestors) keeps the block
    causal."""
    B = q_index.shape[0]
    dev = q_index.device
    kp = torch.arange(S, device=dev)
    if staging_at is not None and attn_bias is None:
        raise ValueError("staging_at needs the per-row tree bias [B, T, T]")
    if staging_at is None:
        mask = ((kp <= q_index[:, :, None])
                & (kp >= start[:, None, None]))                  # [B, T, S]
        at = kv_length
    else:
        prefix = (kp < kv_length[:, None]) & (kp >= start[:, None])  # [B, S]
        in_stage = (kp >= staging_at) & (kp < staging_at + T)
        mask = prefix[:, None, :] | in_stage
        at = staging_at
    if attn_bias is None:
        return mask[:, None, None], None
    bias = torch.zeros((B, T, S), dtype=torch.float32, device=dev)
    bias[:, :, at:at + T] = attn_bias.float()
    return mask[:, None, None], bias[:, None, None]


def attention(q, k, v, mask, bias=None) -> torch.Tensor:
    """q: [B,T,H,d]; k, v: [B,S,Hkv,d] (the full cache buffers of a layer);
    mask [B,1,1,T,S] and bias from `attention_mask`. GQA runs as a grouped
    product over [kv_head, rep]: the repeated K/V is never materialized."""
    B, T, H, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    qg = q.reshape(B, T, Hkv, rep, d)
    scores = torch.einsum("btkrd,bskd->bkrts", qg.float(), k.float())
    scores = scores * (d ** -0.5)
    if bias is not None:
        scores = scores + bias
    # large-negative (not -inf) so fully-masked pad rows stay finite
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrts,bskd->btkrd", probs, v.to(q.dtype))
    return out.reshape(B, T, H, d)


def _embed(cfg: ModelConfig, embed, tokens: torch.Tensor,
           tp_axis=None) -> torch.Tensor:
    """The embedding of `tokens`. An embedding of fewer rows than the
    vocabulary under `tp_axis` is this rank's vocab shard (the GSPMD layout,
    parallel/sharding.py): the lookup takes the tokens in its rows, zeros
    elsewhere, and the shards are psummed (one nonzero term: exact)."""
    table = embed.codes if isinstance(embed, QuantizedEmbedding) else embed
    rows = table.shape[0]
    sharded = tp_axis is not None and rows != cfg.vocab_size
    if sharded:
        if rows * tp_axis.size != cfg.vocab_size:
            raise ValueError(f"embedding of {rows} rows is no vocab shard of "
                             f"{cfg.vocab_size} over {tp_axis.size} ranks")
        local = tokens - tp_axis.index * rows
        inside = (local >= 0) & (local < rows)
        tokens = torch.where(inside, local, 0)
    if isinstance(embed, QuantizedEmbedding):
        x = (embed.codes[tokens].float()
             * embed.scale[tokens].float()[..., None]).to(cfg.dtype)
    else:
        x = embed[tokens].to(cfg.dtype)
    if sharded:
        from ..parallel.mesh import psum
        x = psum(torch.where(inside[..., None], x, torch.zeros_like(x)),
                 tp_axis)
    return x


def forward(cfg: ModelConfig, params: ModelParams, tokens: torch.Tensor,
            cache: KVCache, attn_bias: Optional[torch.Tensor] = None,
            skip_head: bool = False,
            positions: Optional[torch.Tensor] = None,
            feature_layers: Optional[Tuple[int, ...]] = None,
            lengths: Optional[torch.Tensor] = None,
            staging_at: Optional[int] = None, last_only: bool = False,
            slots: int = 1, hidden_in: Optional[torch.Tensor] = None,
            tp_axis=None, ring_axis=None):
    """Run the decoder over `tokens` [B, T], appending to `cache` in place.

    Returns (logits [B, T, V] f32, cache with length += T). RoPE positions
    are the cache index less the row's left pad unless `positions` [B, T]
    is given. With skip_head the final norm and the head are not applied
    and the first item is the last layer's hidden state [B, T, D] (a
    prefill needs only the cache).

    feature_layers: a tuple of layer indices; the call then also returns
    the concatenated INPUTS of those layers [B, T, len*D] as a third item,
    or for (-1,) the final pre-norm hidden state (the EAGLE-1/2 stream).
    lengths (slot-batched serving): [B] per-row cache frontiers (a device
    tensor) in place of `cache.length`, so row b's queries sit at
    lengths[b] + t. Alone, row b's T new keys are written at [lengths[b],
    lengths[b] + T) (kvcache.append_layer_stacked_ragged; the speculative
    slot pool) and attention is causal by each row's own frontier; the
    caller keeps lengths[b] + T inside the cache. With staging_at and a
    per-row attn_bias [B, T, T] (the EAGLE pool), the new keys go to the
    fixed slots [staging_at, staging_at + T) of every row, one uniform
    write, and the caller compacts the accepted ones into each row's
    frontier afterwards (kvcache.compact_path_staged). The returned
    cache's `length` is cache.length + T either way, as in JAX; the
    caller tracks the rows.
    last_only: apply the final norm and the head to the last position only
    (logits [B, 1, V]; a prefill samples from that row alone).
    Every quantized product passes cfg.gptq_mxu_bf16, the head's included.
    slots: the B rows are that many slots of equal rows (a pool's slots);
    every product routes as one slot's rows would (ops.linear.route_rows),
    as the JAX package's per-slot vmapped forward routes them.
    hidden_in: [B, T, D], the hidden stream to enter the first layer with
    in place of the embedding of `tokens`, which then give only the shapes
    (a pipeline stage's hook; with skip_head it leaves with the raw
    pre-norm hidden state for the next stage).

    tp_axis (a parallel.mesh.Axis): the weights and the cache are this
    rank's Megatron shards (parallel/tp.py): H / tp query heads and Hkv / tp
    kv heads, the ffn columns of wgate / wup and rows of wdown, the experts
    or ffn slices of an MoE stack, the vocab columns of the head; the
    activations are replicated. wo's and wdown's products are psummed over
    the axis in the activation dtype, the MoE mix in f32, and the logits
    come back vocab-sharded (the TP forwards gather them). The layout must
    be unfused, so K1 and K2 do not run under TP. An embedding of fewer
    rows than the vocabulary is a vocab shard (`_embed`).
    ring_axis (a parallel.mesh.Axis): sequence-parallel prefill
    (parallel/sp.py): `tokens` are this rank's chunk of the prompt, the
    cache a fresh local one, `positions` the GLOBAL positions; attention is
    `ops.ring_attention` over the chunks of the axis, never K8.

    Attention routes, as the JAX package's (transformer.py:263-269,
    406-412, 483-508): with no lengths and no staging, FD.use_fused_rope_attn
    and no bias, q reaches K8 raw and is rotated inside it (k is still
    rotated here, for the cache); else, with no lengths and no staging,
    where FD.use_flash holds, K8 takes the rotated q; else the einsum path
    (per-row lengths always take it: K8 needs one frontier).
    """
    B, T = tokens.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    if tp_axis is not None:
        from ..parallel.mesh import psum
        tp = tp_axis.size
        if H % tp or Hkv % tp:
            raise ValueError(f"{H} heads / {Hkv} kv heads do not split over "
                             f"{tp} ranks")
        if "wqkv" in params.layers or "wgu" in params.layers:
            raise ValueError("TP runs keep the unfused layout")
        H, Hkv = H // tp, Hkv // tp
    if ring_axis is not None:
        from ..ops.ring_attention import ring_attention
        if positions is None or cache.length != 0:
            raise ValueError("ring attention prefills a fresh cache at "
                             "explicit global positions")
    dev = tokens.device
    length = cache.length
    if staging_at is not None and lengths is None:
        raise ValueError("staging_at needs per-row lengths")
    if lengths is not None and staging_at is None and attn_bias is not None:
        raise ValueError("the ragged append takes no attn_bias")
    ar = torch.arange(T, device=dev)
    if lengths is not None:
        q_index = lengths[:, None] + ar[None, :]
    else:
        q_index = (length + ar)[None, :].expand(B, T)
    if positions is None:
        positions = torch.clamp(q_index - cache.start[:, None], min=0)
    tables = rope_tables(positions, hd, cfg.rope_theta, cfg.rope_scaling)
    one_frontier = lengths is None and ring_axis is None
    fused_rope = (one_frontier and attn_bias is None
                  and FD.use_fused_rope_attn(B, T, hd, cache.max_len))
    mask = bias = None      # the einsum path's, built at its first use

    x = (hidden_in.to(cfg.dtype) if hidden_in is not None
         else _embed(cfg, params.embed, tokens, tp_axis))
    names = params.layers
    first = next(iter(names.values()))
    n_layers = (first.qweight if isinstance(first, QuantizedLinear)
                else first).shape[0]
    eps = cfg.rms_norm_eps
    bf16 = cfg.gptq_mxu_bf16
    collect = feature_layers is not None and tuple(feature_layers) != (-1,)
    layer_inputs = []

    def get(name, l):
        w = names.get(name)
        if w is None or isinstance(w, QuantizedLinear):
            return w
        return w[l]

    k_all, v_all = cache.k, cache.v
    for l in range(n_layers):
        def lin(name, h, bias=None, norm=None):
            return apply_linear(names[name], h, bias, layer=l, norm=norm,
                                mxu_bf16=bf16, slots=slots)

        if collect:
            layer_inputs.append(x)
        if "wqkv" in names:
            qkv = lin("wqkv", x, get("bqkv", l), norm=(names["ln1"][l], eps))
            q = qkv[..., :H * hd]
            k = qkv[..., H * hd:(H + Hkv) * hd]
            v = qkv[..., (H + Hkv) * hd:]
        else:
            h = rms_norm(x, names["ln1"][l], eps)
            q = lin("wq", h, get("bq", l))
            k = lin("wk", h, get("bk", l))
            v = lin("wv", h, get("bv", l))
        q = q.reshape(B, T, H, hd)
        if not fused_rope:
            q = rope_apply(q, tables)
        k = rope_apply(k.reshape(B, T, Hkv, hd), tables)
        v = v.reshape(B, T, Hkv, hd)
        if staging_at is None and lengths is not None:
            append_layer_stacked_ragged(k_all, v_all, l, lengths, k, v)
        else:
            append_layer_stacked(k_all, v_all, l,
                                 length if staging_at is None else staging_at,
                                 k, v)
        if ring_axis is not None:
            att = ring_attention(q, k, v, positions, ring_axis).to(q.dtype)
        elif fused_rope:
            att = FD.flash_attention_decode(q, k_all[l], v_all[l], q_index,
                                            length, cache.start, None,
                                            rope=tables)
        elif one_frontier and FD.use_flash(q, k_all[l]):
            att = FD.flash_attention_decode(q, k_all[l], v_all[l], q_index,
                                            length, cache.start, attn_bias)
        else:
            if mask is None:
                mask, bias = attention_mask(
                    q_index, cache.start, cache.max_len, T,
                    lengths if lengths is not None else length, attn_bias,
                    staging_at)
            att = attention(q, k_all[l], v_all[l], mask, bias)
        att2 = att.reshape(B, T, H * hd)
        if "wgu" in names and attn_mlp_fusable(
                att2, names["wo"], names["wgu"], names["wdown"], layer=l,
                slots=slots):
            # packed-int4 layer tail at decode/verify rows: one K2 call
            x = apply_attn_mlp(att2, x, names["wo"], names["wgu"],
                               names["wdown"], names["ln2"][l], eps, layer=l)
            continue
        y = lin("wo", att2)
        x = x + (y if tp_axis is None else psum(y, tp_axis))
        if "gate" in names:
            x = x + _moe_ffn(cfg, moe_params(names, l),
                             rms_norm(x, names["ln2"][l], eps), slots=slots,
                             tp_axis=tp_axis)
        elif "wgu" in names:
            x = x + apply_mlp(names["wgu"], names["wdown"], x,
                              names["ln2"][l], eps, layer=l, mxu_bf16=bf16,
                              slots=slots)
        else:
            h = rms_norm(x, names["ln2"][l], eps)
            ff = F.silu(lin("wgate", h)) * lin("wup", h)
            y = lin("wdown", ff)
            x = x + (y if tp_axis is None else psum(y, tp_axis))

    new_cache = cache.replace(length=length + T)
    feats = None
    if feature_layers is not None:
        feats = (torch.cat([layer_inputs[i] for i in feature_layers], dim=-1)
                 if collect else x)
    if skip_head:
        out = x
    else:
        if last_only:
            x = x[:, -1:]
        x = rms_norm(x, params.final_norm, eps)
        if params.lm_head is None:
            if isinstance(params.embed, QuantizedEmbedding):
                raise ValueError("a tied head needs a dense embedding")
            head = params.embed.t()
        else:
            head = params.lm_head
        out = apply_linear(head, x, mxu_bf16=bf16, slots=slots).float()
    if feature_layers is not None:
        return out, new_cache, feats
    return out, new_cache
