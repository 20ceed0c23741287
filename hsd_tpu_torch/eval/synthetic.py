"""Synthetic coupled draft/target pairs (port of the main-path part of
`hsd_tpu/eval/synthetic.py`).

    q = softmax(small_int8(x))                    # the draft (0.5B cost)
    p = softmax(small_bf16(x) + lam * zbig(x))    # the target (14B cost)

`small_int8` is the asymmetric int8 GPTQ image of the bf16 small trunk and
`zbig` the big model's per-position standardized logits, so every committed
token pays the full big forward while agreement with the draft is set by
quantization error (and `lam`). Full-width weights are built natively on
the device from a seeded torch.Generator.

The EAGLE twin (`build_coupled_eagle_pair`): a v1 head that computes an
exact bigram oracle u(tok) at the full head cost, and a symmetric quantized
big trunk (int8, or packed int4 with big_bits=4) whose target logits are
scale * standardize(u) + lam * standardize(big), so trie acceptance is set
by (scale, lam) while every position pays the full big forward.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import ModelConfig
from ..engine.kvcache import KVCache, init_cache, rollback, select_draft_row
from ..models import transformer
from ..models.transformer import (ModelParams, QuantizedEmbedding,
                                  fuse_params, resolve_device)
from ..ops.linear import QuantizedLinear, quantize
from ..models.eagle import EagleConfig, EagleParams, init_eagle_params_v1


class CoupledCache(NamedTuple):
    big: KVCache
    small: KVCache


class CoupledParams(NamedTuple):
    big: ModelParams
    small: ModelParams
    lam: float   # weight of the standardized big logits


def make_coupled_target(cfg_small: ModelConfig, cfg_big: ModelConfig):
    """Return `(forward, cache_ops)` for the coupled target, in
    make_generate's target_forward / target_cache_ops protocol. With
    skip_head neither trunk applies its head and the first item is None."""
    if cfg_small.vocab_size != cfg_big.vocab_size:
        raise ValueError("the coupled pair needs one vocabulary")

    def forward(params: CoupledParams, tokens, cache: CoupledCache,
                skip_head: bool = False):
        big_logits, bigc = transformer.forward(cfg_big, params.big, tokens,
                                               cache.big, skip_head=skip_head)
        small_logits, smallc = transformer.forward(cfg_small, params.small,
                                                   tokens, cache.small,
                                                   skip_head=skip_head)
        if skip_head:
            return None, CoupledCache(big=bigc, small=smallc)
        mu = torch.mean(big_logits, dim=-1, keepdim=True)
        sd = torch.std(big_logits, dim=-1, keepdim=True, unbiased=False) + 1e-6
        logits = small_logits + params.lam * (big_logits - mu) / sd
        return logits, CoupledCache(big=bigc, small=smallc)

    def init(batch, max_len, start, device):
        return CoupledCache(
            big=init_cache(cfg_big, batch, max_len, device).replace(
                start=start.clone()),
            small=init_cache(cfg_small, batch, max_len, device).replace(
                start=start.clone()))

    def rb(cache: CoupledCache, new_length):
        return CoupledCache(big=rollback(cache.big, new_length),
                            small=rollback(cache.small, new_length))

    def sel(cache: CoupledCache, row):
        return CoupledCache(big=select_draft_row(cache.big, row),
                            small=select_draft_row(cache.small, row))

    return forward, (init, rb, sel)


def group_size(din: int) -> int:
    """128 (the GPTQ default) when it divides the in-features, else one group
    per matrix (tiny test geometries)."""
    return 128 if din % 128 == 0 else din


def _random_q(gen, dev, din: int, dout: int, layers, bits: int):
    """Random symmetric quantized weight stack [*layers, ...] (layers: L, or
    (L, E) for an expert stack): codes uniform over the full int4 (packed)
    or [-127, 127] int8 range, bf16 scales |N(0,1)| * 1e-2 + 1e-3, one
    group per 128 input rows. Codes are drawn in place, one [din, dout]
    matrix at a time, so no wider intermediate is ever held."""
    lead = (layers,) if isinstance(layers, int) else tuple(layers)
    if bits == 4:
        qweight = torch.empty((*lead, din // 2, dout), dtype=torch.uint8,
                              device=dev)
        for mat in qweight.view(-1, din // 2, dout):
            mat.random_(0, 256, generator=gen)     # two uniform nibbles
    else:
        qweight = torch.empty((*lead, din, dout), dtype=torch.int8,
                              device=dev)
        for mat in qweight.view(-1, din, dout):
            mat.random_(-127, 128, generator=gen)
    g = din // group_size(din)
    scales = (torch.randn((*lead, g, dout), generator=gen, device=dev).abs()
              * 1e-2 + 1e-3).to(torch.bfloat16)
    return QuantizedLinear(qweight=qweight, scales=scales, zeros=None)


def init_quantized_params(cfg: ModelConfig, seed: int = 0, bits: int = 4,
                          device=None) -> ModelParams:
    """Random big-geometry model with quantized weights, built directly in the
    fused layout (wqkv / wgu) with an int8 embedding and an untied
    quantized head. With cfg.is_moe the MLP is a random f32 router `gate`
    [L, D, E] (N(0, 1/D): unit-scale logits on a normed input) and unfused
    expert stacks wgate / wup [L, E, D, F], wdown [L, E, F, D], drawn one
    (layer, expert) matrix at a time. The JAX package's counterpart has
    no MoE branch: this is random-weight scaffolding for the card."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, Fi, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    layers = dict(
        ln1=torch.ones((L, D), device=dev),
        ln2=torch.ones((L, D), device=dev),
        wqkv=_random_q(gen, dev, D, (H + 2 * Hkv) * hd, L, bits),
        wo=_random_q(gen, dev, H * hd, D, L, bits),
    )
    if cfg.is_moe:
        E = cfg.num_experts
        layers.update(
            gate=torch.randn((L, D, E), generator=gen, device=dev)
            * D ** -0.5,
            wgate=_random_q(gen, dev, D, Fi, (L, E), bits),
            wup=_random_q(gen, dev, D, Fi, (L, E), bits),
            wdown=_random_q(gen, dev, Fi, D, (L, E), bits))
    else:
        layers.update(wgu=_random_q(gen, dev, D, 2 * Fi, L, bits),
                      wdown=_random_q(gen, dev, Fi, D, L, bits))
    if cfg.attention_bias:
        layers["bqkv"] = torch.zeros((L, (H + 2 * Hkv) * hd), dtype=cfg.dtype,
                                     device=dev)
    codes = torch.empty((cfg.vocab_size, D), dtype=torch.int8, device=dev)
    codes.random_(-127, 128, generator=gen)
    embed = QuantizedEmbedding(
        codes=codes, scale=torch.full((cfg.vocab_size,), 2e-4, device=dev))
    head = _random_q(gen, dev, D, cfg.vocab_size, 1, bits).layer(0)
    return ModelParams(embed=embed, layers=layers,
                       final_norm=torch.ones((D,), device=dev), lm_head=head)


def quantize_draft(cfg: ModelConfig, params: ModelParams,
                   bits: int = 8) -> ModelParams:
    """Asymmetric GPTQ-style quantization of a small model's stacked matmul
    weights (the draft is the int8 image of the target's small trunk). The
    embedding and the tied head stay as they are."""
    L = dict(params.layers)
    for name in ("wqkv", "wo", "wgu", "wdown", "wq", "wk", "wv", "wgate",
                 "wup"):
        if name in L and not isinstance(L[name], QuantizedLinear):
            gs = group_size(L[name].shape[-2])
            per_layer = [quantize(w, bits=bits, group_size=gs) for w in L[name]]
            L[name] = QuantizedLinear(
                qweight=torch.stack([w.qweight for w in per_layer]),
                scales=torch.stack([w.scales for w in per_layer]),
                zeros=torch.stack([w.zeros for w in per_layer]))
    return params._replace(layers=L)


def build_coupled_pair(seed: int, cfg_small: ModelConfig,
                       cfg_big: ModelConfig, lam: float,
                       logit_scale: float = 1.65, big_bits: int = 4,
                       device=None) -> Tuple[ModelParams, CoupledParams]:
    """(draft_params, target_params) for the coupled benchmark. logit_scale
    sharpens the small trunk's logits; lam sets the extra target-only
    divergence."""
    dev = resolve_device(device)
    small = transformer.init_params(cfg_small, seed=seed + 1, device=dev)
    small = small._replace(
        embed=(small.embed.float() * logit_scale).to(cfg_small.dtype))
    small = fuse_params(cfg_small, small)
    draft = quantize_draft(cfg_small, small, bits=8)
    big = init_quantized_params(cfg_big, seed=seed, bits=big_bits, device=dev)
    return draft, CoupledParams(big=big, small=small, lam=float(lam))


class CoupledEagleParams(NamedTuple):
    """The coupled EAGLE target: the big trunk plus the bigram oracle's
    pieces, which share the head's arrays."""
    big: ModelParams
    embed: torch.Tensor     # [V, D]  the head's embed
    fc_e: torch.Tensor      # [D, D]  the embedding half of the head's fc
    lm_head: torch.Tensor   # [D, V]  the head's lm_head, extended to V
    scale: float            # sharpening of the oracle signal
    lam: float              # weight of the standardized big logits


def build_bigram_eagle_head(ecfg: EagleConfig, seed: int = 0,
                            device=None) -> EagleParams:
    """A v1 head that computes an EXACT bigram oracle while paying the full
    head compute: with fc = [A; 0], fc_b = 0, wo = 0 and wdown = 0 the head
    collapses to out = A @ emb[token] at every absorb position and beam
    level, so its logits are u(tok) = (emb[tok] @ A) @ lm_head. Attention
    and MLP still run with random nonzero weights, at the real cost."""
    dev = resolve_device(device)
    p = init_eagle_params_v1(ecfg, seed=seed, device=dev)
    D = ecfg.hidden_size
    gen = torch.Generator(device=dev).manual_seed(seed + 101)
    A = (torch.randn((D, D), generator=gen, device=dev) * D ** -0.5
         ).to(ecfg.dtype)
    return p._replace(fc=torch.cat([A, torch.zeros_like(A)], 0),
                      fc_b=torch.zeros((D,), dtype=ecfg.dtype, device=dev),
                      wo=torch.zeros_like(p.wo),
                      wdown=torch.zeros_like(p.wdown))


def oracle_logits(cp: CoupledEagleParams, tokens: torch.Tensor
                  ) -> torch.Tensor:
    """u(tok) = (emb[tok] @ fc_e) @ lm_head, the same two products the head
    runs, in the same dtype."""
    return (cp.embed[tokens] @ cp.fc_e @ cp.lm_head).float()


def _standardize(x: torch.Tensor) -> torch.Tensor:
    mu = torch.mean(x, dim=-1, keepdim=True)
    sd = torch.std(x, dim=-1, keepdim=True, unbiased=False) + 1e-6
    return (x - mu) / sd


def make_coupled_eagle_target(cfg_big: ModelConfig, feature_layers):
    """Coupled target forward for the EAGLE engine (make_eagle_block's
    target_forward protocol): logits = scale * standardize(u(token)) + lam
    * standardize(big), both over the vocabulary of each position. With
    last_only (a prefill), the big head and the oracle run on the last
    position only."""
    def forward(cp: CoupledEagleParams, tokens, cache, attn_bias, positions,
                lengths=None, staging_at=None, last_only=False):
        big_logits, cache, feats = transformer.forward(
            cfg_big, cp.big, tokens, cache, attn_bias=attn_bias,
            positions=positions, feature_layers=feature_layers,
            lengths=lengths, staging_at=staging_at, last_only=last_only)
        u = oracle_logits(cp, tokens[:, -1:] if last_only else tokens)
        return (cp.scale * _standardize(u) + cp.lam * _standardize(big_logits),
                cache, feats)

    return forward


def build_coupled_eagle_pair(seed: int, cfg_big: ModelConfig,
                             ecfg: EagleConfig, scale: float = 4.0,
                             lam: float = 0.0, big_bits: int = 8,
                             oov_scale: float = 0.5, device=None):
    """(head_params, CoupledEagleParams) at big geometry: a quantized big
    trunk (symmetric int8 with big_bits=8, packed int4 with big_bits=4; an
    int8 embedding and a head of the same width either way) and the
    bigram-oracle v1 head, sharing embed, fc and lm_head with the target's
    oracle. The oracle does not depend on big_bits.

    With a reduced draft vocab (draft_vocab_size < vocab_size) the head
    ranks the first Vd target ids and the oracle extends the same matrix
    with down-weighted columns (`oov_scale`) for the others. lm_head is
    then scaled so the head's logit std per row is about `scale`, the
    sharpness of the target term."""
    dev = resolve_device(device)
    head = build_bigram_eagle_head(ecfg, seed=seed + 1, device=dev)
    big = init_quantized_params(cfg_big, seed=seed, bits=big_bits, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    D = ecfg.hidden_size
    Vd, V = ecfg.draft_vocab_size, ecfg.vocab_size
    if Vd < V:
        rest = (torch.randn((D, V - Vd), generator=gen, device=dev)
                * D ** -0.5 * oov_scale).to(ecfg.dtype)
        lm_full = torch.cat([head.lm_head, rest], 1)
        del rest
    else:
        lm_full = head.lm_head.clone()
    probe = torch.randint(0, V, (128,), generator=gen, device=dev)
    u_probe = head.embed[probe] @ head.fc[:D] @ lm_full
    sd = torch.mean(torch.std(u_probe.float(), dim=-1, unbiased=False))
    factor = (scale / torch.clamp(sd, min=1e-6)).to(ecfg.dtype)
    head = head._replace(lm_head=head.lm_head * factor)
    lm_full.mul_(factor)
    target = CoupledEagleParams(big=big, embed=head.embed,
                                fc_e=head.fc[:D], lm_head=lm_full,
                                scale=float(scale), lam=float(lam))
    return head, target
