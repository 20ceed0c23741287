"""EAGLE feature-level draft heads and trie drafting (port of
`hsd_tpu/models/eagle.py`).

  * the EAGLE-3 head (version 3): ONE fused decoder layer whose attention
    reads cat(rmsnorm(token_emb), rmsnorm(hidden)), 2D wide, with the
    hidden stream as its residual; fc fuses the target's three feature
    layers (3*Dt -> D) where the head absorbs them; the head's own final
    norm before its lm_head over the reduced draft vocabulary;
  * the EAGLE-1/2 head (version 1): hidden = fc(cat(token_emb, feature)) +
    bias, then one decoder layer whose input norm is the identity, and the
    target's lm_head over the draft vocabulary without an extra norm;
  * `quantize_eagle_params`: the head's matmuls as symmetric int8;
  * trie drafting: a depth-step beam search with top_k children per node and
    cumulative log-probs, then a global top-(total_tokens) cut over every
    scored node, the ancestor mask, depths and the leaf-to-root paths sorted
    as the reference sorts them.

The JAX package runs one slot per call and vmaps over slots; here a slot
axis is written out: every tensor carries a leading [B], and EagleKV keeps a
frontier and a left pad per row. Buffers are updated in place. The beam's
levels are a Python loop (depth steps); the ancestor closure walks parent
pointers depth + 1 times instead of scanning the N nodes.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.linear import apply_linear, quantize, rms_norm
from .transformer import resolve_device, rope_apply, rope_tables


@dataclasses.dataclass(frozen=True)
class EagleConfig:
    hidden_size: int
    target_hidden_size: int
    num_heads: int
    num_kv_heads: int
    vocab_size: int          # target vocab
    draft_vocab_size: int    # reduced draft vocab (== vocab_size when full)
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    # Llama-3.1 frequency-dependent RoPE scaling tuple (ModelConfig's)
    rope_scaling: Optional[Tuple[float, float, float, int]] = None
    intermediate_size: int = 0
    top_k: int = 10
    depth: int = 6
    total_tokens: int = 59   # nodes in the final trie EXCLUDING the root
    dtype: torch.dtype = torch.bfloat16
    # 3 = EAGLE-3 fused head, 1 = EAGLE-1/2 head (the JAX package's
    # default and meaning)
    version: int = 3

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def from_json(path: str, **overrides) -> "EagleConfig":
        """An EAGLE head config JSON (the reference's EConfig files): the
        fields the head reads, with the reference's defaults."""
        with open(path) as f:
            c = json.load(f)
        d = dict(
            hidden_size=c["hidden_size"],
            target_hidden_size=c.get("target_hidden_size", c["hidden_size"]),
            num_heads=c["num_attention_heads"],
            num_kv_heads=c.get("num_key_value_heads",
                               c["num_attention_heads"]),
            vocab_size=c["vocab_size"],
            draft_vocab_size=c.get("draft_vocab_size", c["vocab_size"]),
            rms_norm_eps=c.get("rms_norm_eps", 1e-5),
            rope_theta=c.get("rope_theta", 500000.0),
            intermediate_size=c.get("intermediate_size", 0),
        )
        d.update(overrides)
        return EagleConfig(**d)


class EagleParams(NamedTuple):
    """The head's weights; each matmul field is a dense tensor or a
    QuantizedLinear (`quantize_eagle_params`)."""

    embed: torch.Tensor      # [V, D] target embeddings
    fc: torch.Tensor         # [3*Dt, D] (v3) / [2*D, D] (v1)
    ln_input: torch.Tensor   # [D] token-embedding norm (v3; v1: unused)
    ln_hidden: torch.Tensor  # [D] hidden-stream norm (v3; v1: unused)
    wq: torch.Tensor         # [2D, H*hd] (v3) / [D, H*hd] (v1)
    wk: torch.Tensor         # [2D, Hkv*hd] / [D, Hkv*hd]
    wv: torch.Tensor         # [2D, Hkv*hd] / [D, Hkv*hd]
    wo: torch.Tensor         # [H*hd, D]
    ln_post: torch.Tensor    # [D]
    wgate: torch.Tensor      # [D, F]
    wup: torch.Tensor        # [D, F]
    wdown: torch.Tensor      # [F, D]
    norm: torch.Tensor       # [D] final norm before lm_head (v3; v1: unused)
    lm_head: torch.Tensor    # [D, Vd]
    d2t: torch.Tensor        # [Vd] int64: target_id = draft_id + d2t
    t2d: torch.Tensor        # [V] bool membership
    fc_b: Optional[torch.Tensor] = None   # [D] fc bias (v1 only)


def init_eagle_params(cfg: EagleConfig, seed: int = 0,
                      device=None) -> EagleParams:
    """Random EAGLE-3 head from a seeded torch.Generator on the device:
    fc [3*Dt, D], the attention 2D wide."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, Dt = cfg.hidden_size, cfg.target_hidden_size
    Fi = cfg.intermediate_size or 4 * D
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def dense(shape):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * shape[0] ** -0.5).to(cfg.dtype)

    ones = lambda: torch.ones((D,), device=dev)
    return EagleParams(
        embed=dense((cfg.vocab_size, D)), fc=dense((3 * Dt, D)),
        ln_input=ones(), ln_hidden=ones(),
        wq=dense((2 * D, H * hd)), wk=dense((2 * D, Hkv * hd)),
        wv=dense((2 * D, Hkv * hd)), wo=dense((H * hd, D)), ln_post=ones(),
        wgate=dense((D, Fi)), wup=dense((D, Fi)), wdown=dense((Fi, D)),
        norm=ones(), lm_head=dense((D, cfg.draft_vocab_size)),
        d2t=torch.zeros((cfg.draft_vocab_size,), dtype=torch.int64,
                        device=dev),
        t2d=torch.ones((cfg.vocab_size,), dtype=torch.bool, device=dev))


def init_eagle_params_v1(cfg: EagleConfig, seed: int = 0, device=None,
                         target_lm_head: Optional[torch.Tensor] = None
                         ) -> EagleParams:
    """Random EAGLE-1/2 head from a seeded torch.Generator on the device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D = cfg.hidden_size
    Fi = cfg.intermediate_size or 4 * D
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def dense(shape):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * shape[0] ** -0.5).to(cfg.dtype)

    lm = (target_lm_head if target_lm_head is not None
          else dense((D, cfg.draft_vocab_size)))
    ones = lambda: torch.ones((D,), device=dev)
    return EagleParams(
        embed=dense((cfg.vocab_size, D)), fc=dense((2 * D, D)),
        fc_b=torch.zeros((D,), dtype=cfg.dtype, device=dev),
        ln_input=ones(), ln_hidden=ones(),
        wq=dense((D, H * hd)), wk=dense((D, Hkv * hd)),
        wv=dense((D, Hkv * hd)), wo=dense((H * hd, D)), ln_post=ones(),
        wgate=dense((D, Fi)), wup=dense((D, Fi)), wdown=dense((Fi, D)),
        norm=ones(), lm_head=lm,
        d2t=torch.zeros((cfg.draft_vocab_size,), dtype=torch.int64,
                        device=dev),
        t2d=torch.ones((cfg.vocab_size,), dtype=torch.bool, device=dev))


def quantize_eagle_params(params: EagleParams, bits: int = 8,
                          group_size: int = 128) -> EagleParams:
    """The head's matmuls (fc, wq/wk/wv/wo, wgate/wup/wdown, lm_head) as
    symmetric GPTQ weights with groups of gcd(rows, group_size), bit for
    bit as the JAX package quantizes them; embed, the norms, d2t and t2d
    stay dense. The head only proposes: the verifier keeps the target's
    law whatever the head's precision, so this moves acceptance rates only.
    The head's products pass no mxu_bf16, so they keep f32 operands at
    every row count."""
    def qz(w):
        gs = math.gcd(w.shape[0], group_size)
        return quantize(w.float(), bits=bits, group_size=gs, symmetric=True)

    return params._replace(
        fc=qz(params.fc), wq=qz(params.wq), wk=qz(params.wk),
        wv=qz(params.wv), wo=qz(params.wo), wgate=qz(params.wgate),
        wup=qz(params.wup), wdown=qz(params.wdown),
        lm_head=qz(params.lm_head))


class EagleKV(NamedTuple):
    k: torch.Tensor        # [B, S, Hkv, hd]
    v: torch.Tensor
    length: torch.Tensor   # int64 [B] frontier of each row
    start: torch.Tensor    # int64 [B] dead left-pad slots [0, start)


def init_eagle_kv(cfg: EagleConfig, batch: int, max_len: int,
                  device) -> EagleKV:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    zeros = lambda: torch.zeros((batch,), dtype=torch.int64, device=device)
    return EagleKV(torch.zeros(shape, dtype=cfg.dtype, device=device),
                   torch.zeros(shape, dtype=cfg.dtype, device=device),
                   zeros(), zeros())


def head_forward(cfg: EagleConfig, p: EagleParams, token_emb: torch.Tensor,
                 hidden: torch.Tensor, kv: EagleKV, positions: torch.Tensor,
                 kv_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, EagleKV]:
    """One fused-decoder-layer forward of the head.

    token_emb: [B, T, D] embeddings of the (shifted) tokens; hidden:
    [B, T, D] the feature branch (target features through fc for v3, raw
    for v1, or the head's own outputs during the beam); positions: [B, T];
    kv_mask: [B, T, S] attention mask override (True = attend), else
    causal by slot from each row's frontier. Row b writes its T keys at
    kv.length[b], clipped so they fit (as dynamic_update_slice clips).
    Returns (out_hidden [B, T, D], kv with length += T).
    """
    B, T, D = token_emb.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = token_emb.device
    if cfg.version == 1:
        # hidden = fc(cat(emb, hidden)) + bias; the input norm is identity
        x = apply_linear(p.fc, torch.cat([token_emb, hidden], -1), p.fc_b)
        residual = x
    else:
        residual = hidden
        eps = cfg.rms_norm_eps
        x = torch.cat([rms_norm(token_emb, p.ln_input, eps),
                       rms_norm(hidden, p.ln_hidden, eps)], -1)
    tables = rope_tables(positions, hd, cfg.rope_theta, cfg.rope_scaling)
    q = rope_apply(apply_linear(p.wq, x).reshape(B, T, H, hd), tables)
    k = rope_apply(apply_linear(p.wk, x).reshape(B, T, Hkv, hd), tables)
    v = apply_linear(p.wv, x).reshape(B, T, Hkv, hd)

    S = kv.k.shape[1]
    ar = torch.arange(T, device=dev)
    at = torch.clamp(kv.length, 0, S - T)[:, None] + ar[None, :]
    b_ids = torch.arange(B, device=dev)[:, None].expand(B, T)
    kv.k[b_ids, at] = k.to(kv.k.dtype)
    kv.v[b_ids, at] = v.to(kv.v.dtype)

    rep = H // Hkv
    qg = q.reshape(B, T, Hkv, rep, hd)
    scores = torch.einsum("btkrd,bskd->bkrts", qg.float(),
                          kv.k.float()) * hd ** -0.5
    if kv_mask is None:
        slot = torch.arange(S, device=dev)[None, None, :]
        qslot = (kv.length[:, None] + ar[None, :])[:, :, None]
        kv_mask = (slot <= qslot) & (slot >= kv.start[:, None, None])
    scores = torch.where(kv_mask[:, None, None], scores, -1e30)
    att = torch.einsum("bkrts,bskd->btkrd",
                       torch.softmax(scores, -1).to(q.dtype),
                       kv.v.to(q.dtype))
    out = residual + apply_linear(p.wo, att.reshape(B, T, H * hd))
    h = rms_norm(out, p.ln_post, cfg.rms_norm_eps)
    out = out + apply_linear(p.wdown, F.silu(apply_linear(p.wgate, h))
                             * apply_linear(p.wup, h))
    return out, kv._replace(length=kv.length + T)


def draft_logp(cfg: EagleConfig, p: EagleParams,
               hidden: torch.Tensor) -> torch.Tensor:
    """log-softmax over the DRAFT vocab: v3 norms with the head's final
    norm first; the v1 head applies the target lm_head directly."""
    h = (hidden if cfg.version == 1
         else rms_norm(hidden, p.norm, cfg.rms_norm_eps))
    return torch.log_softmax(apply_linear(p.lm_head, h).float(), -1)


class Trie(NamedTuple):
    """Drafted token tries, one per row, N = total_tokens."""

    draft_tokens: torch.Tensor      # [B, N+1] int64, col 0 = the root
    parents: torch.Tensor           # [B, N+1] parent node index (-1 root)
    tree_mask: torch.Tensor         # [B, N+1, N+1] bool ancestor closure
    position_ids: torch.Tensor      # [B, N+1] depth of each node
    retrieve_indices: torch.Tensor  # [B, N+1, depth+2] leaf->root paths, -1 pad
    num_paths: torch.Tensor         # [B] number of valid leaf paths
    path_len: torch.Tensor          # [B, N+1] valid length of each path row


def gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [B, M, ...], idx [B, K] -> t[b, idx[b, k]] [B, K, ...]."""
    shape = idx.shape + t.shape[2:]
    flat = idx.reshape(idx.shape[0], -1)
    for _ in t.shape[2:]:
        flat = flat[..., None]
    g = torch.gather(t, 1, flat.expand((flat.shape[0], flat.shape[1])
                                       + t.shape[2:]))
    return g.reshape(shape)


def absorb(cfg: EagleConfig, p: EagleParams, target_features: torch.Tensor,
           tokens: torch.Tensor, kv: EagleKV, prefix_len: torch.Tensor
           ) -> Tuple[torch.Tensor, EagleKV]:
    """Absorb T accepted (feature, token) pairs of every row into the head
    KV at prefix_len: v3 fuses the feature layers through fc first, v1's fc
    runs inside head_forward. Returns (out_hidden [B, T, D], kv')."""
    feat = target_features.to(cfg.dtype)
    if cfg.version != 1:
        feat = apply_linear(p.fc, feat)
    emb = p.embed[tokens].to(cfg.dtype)
    T = tokens.shape[1]
    pos = prefix_len[:, None] + torch.arange(T, device=tokens.device)[None] \
        - kv.start[:, None]
    return head_forward(cfg, p, emb, feat, kv, pos)


def build_trie(cfg: EagleConfig, p: EagleParams,
               target_features: torch.Tensor, tokens: torch.Tensor,
               kv: EagleKV, prefix_len: torch.Tensor,
               root_token: torch.Tensor) -> Tuple[Trie, EagleKV]:
    """Beam-search the draft trie of every row (reference topK_genrate,
    cnets.py:670-827).

    target_features: [B, T, Dt] target features of the newly accepted
    tokens ([B, T, 3*Dt], the three feature layers, for v3, absorbed
    through fc); tokens: [B, T] the (shifted) token ids; kv holds the head's
    prefix KV and prefix_len [B] its valid positions; root_token [B] the
    newest committed token. Returns (Trie, kv') with kv' holding prefix + T
    entries; the trie region written during the beam is scratch past
    kv'.length.
    """
    K, depth, N = cfg.top_k, cfg.depth, cfg.total_tokens
    B, T = tokens.shape
    dev = tokens.device
    i64 = torch.int64
    out_hidden, kv = absorb(cfg, p, target_features, tokens, kv, prefix_len)
    last_hidden = out_hidden[:, -1]                      # [B, D]
    kv_stable = kv

    logp = draft_logp(cfg, p, last_hidden)               # [B, Vd]
    top_p, top_i = torch.topk(logp, K, dim=-1)
    tokens0 = top_i + p.d2t[top_i]
    scores0 = top_p
    D = last_hidden.shape[-1]
    hid = last_hidden[:, None, :].expand(B, K, D)
    tok, sc = tokens0, scores0
    anc = torch.zeros((B, K, depth * K), dtype=torch.bool, device=dev)

    base_len = kv.length                                 # trie region start
    S = kv.k.shape[1]
    slot = torch.arange(S, device=dev)[None, :]
    prefix_mask = (slot < base_len[:, None]) & (slot >= kv.start[:, None])
    trie_slot = slot - base_len[:, None]                 # [B, S]
    in_trie = (trie_slot >= 0) & (trie_slot < depth * K)
    trie_idx = torch.clamp(trie_slot, 0, depth * K - 1)[:, None, :].expand(
        B, K, S)
    beam = torch.arange(K, device=dev)
    cu_all, cand_all, sel_all = [], [], []
    for i in range(depth):
        anc_mask = torch.gather(anc, 2, trie_idx) & in_trie[:, None, :]
        self_mask = trie_slot[:, None, :] == (i * K + beam)[None, :, None]
        mask = prefix_mask[:, None, :] | anc_mask | self_mask    # [B, K, S]
        emb_t = p.embed[tok].to(cfg.dtype)
        posb = (prefix_len + T + i - kv.start)[:, None].expand(B, K)
        kv_in = EagleKV(kv.k, kv.v, base_len + i * K, kv.start)
        out, _ = head_forward(cfg, p, emb_t, hid, kv_in, posb, mask)
        logp = draft_logp(cfg, p, out)                   # [B, K, Vd]
        ctop_p, ctop_i = torch.topk(logp, K, dim=-1)     # [B, K, K]
        cu = ctop_p + sc[:, :, None]
        sel_p, sel_i = torch.topk(cu.reshape(B, K * K), K, dim=-1)
        parent_row = sel_i // K
        new_tok = torch.gather(ctop_i.reshape(B, K * K), 1, sel_i)
        tok = new_tok + p.d2t[new_tok]
        hid = gather_rows(out, parent_row)
        anc = gather_rows(anc, parent_row) | F.one_hot(
            i * K + parent_row, depth * K).bool()
        sc = sel_p
        cu_all.append(cu)
        cand_all.append(ctop_i)
        sel_all.append(sel_i)

    # flat layout of every scored node (the reference's ordering):
    # [K level-0] ++ [K*K level-1] ++ ... ++ [K*K level-depth]
    flat_scores = torch.cat([scores0, torch.stack(cu_all, 1).reshape(
        B, depth * K * K)], 1)
    lvl_tokens = torch.stack(cand_all, 1).reshape(B, depth * K * K)
    flat_tokens = torch.cat([tokens0, lvl_tokens + p.d2t[lvl_tokens]], 1)
    # parent (flat index) of every scored node: level-0 nodes have the root
    # (-1); the candidates of level l hang off the beam that entered it
    lvl = torch.arange(depth, device=dev)[None, :, None]
    beam_ids = K + lvl * K * K + torch.stack(sel_all, 1)   # [B, depth, K]
    prev_beam = torch.cat([beam.expand(B, 1, K), beam_ids[:, :-1]], 1)
    lvl_parents = prev_beam[:, :, :, None].expand(B, depth, K, K).reshape(
        B, depth * K * K)
    flat_parents = torch.cat([torch.full((B, K), -1, dtype=i64, device=dev),
                              lvl_parents], 1)

    # global top-N cut, in ascending flat order
    top_idx = torch.sort(torch.topk(flat_scores, N, dim=-1).indices,
                         dim=-1).values
    sel_tokens = torch.gather(flat_tokens, 1, top_idx)
    sel_parent_flat = torch.gather(flat_parents, 1, top_idx)
    pos_in_sel = torch.searchsorted(top_idx, sel_parent_flat)
    parent_node = torch.where(sel_parent_flat < 0, 0, pos_in_sel + 1)
    draft_tokens = torch.cat([root_token[:, None].to(i64), sel_tokens], 1)
    parents = torch.cat([torch.full((B, 1), -1, dtype=i64, device=dev),
                         parent_node], 1)                   # [B, N+1]

    # ancestor closure: each node and every node up its parent chain
    nodes = torch.arange(N + 1, device=dev)[None].expand(B, N + 1)
    tree_mask = F.one_hot(nodes, N + 1).bool()
    cur = nodes
    for _ in range(depth + 1):
        cur = torch.where(cur > 0,
                          torch.gather(parents, 1, torch.clamp(cur, min=0)),
                          -1)
        tree_mask |= F.one_hot(torch.clamp(cur, min=0), N + 1).bool() \
            & (cur >= 0)[..., None]
    position_ids = tree_mask.sum(-1) - 1

    # leaf paths, root first, rows sorted as the reference's custom_sort
    is_parent = torch.zeros((B, N + 1), dtype=torch.bool, device=dev)
    is_parent.scatter_(1, parent_node, True)
    is_parent[:, 0] = True
    is_leaf = ~is_parent
    Lp = depth + 2
    chain = [nodes]
    for _ in range(Lp - 1):
        c = chain[-1]
        chain.append(torch.where(
            c > 0, torch.gather(parents, 1, torch.clamp(c, min=0)), -1))
    chain = torch.stack(chain, -1)                       # [B, N+1, Lp]
    j = torch.arange(Lp, device=dev)
    d = position_ids[..., None]
    paths = torch.where(j <= d, torch.gather(
        chain, 2, torch.clamp(d - j, 0, Lp - 1)), -1)
    big = N + 5
    keys = torch.where(paths < 0, big, paths)
    keys = torch.where(is_leaf[..., None], keys, big)
    order = nodes
    for col in range(Lp - 1, -1, -1):
        kc = torch.gather(keys[..., col], 1, order)
        order = torch.gather(order, 1, torch.argsort(kc, dim=1, stable=True))
    num_paths = is_leaf.sum(-1)
    retrieve = torch.where((nodes < num_paths[:, None])[..., None],
                           gather_rows(paths, order), -1)
    trie = Trie(draft_tokens=draft_tokens, parents=parents,
                tree_mask=tree_mask, position_ids=position_ids,
                retrieve_indices=retrieve, num_paths=num_paths,
                path_len=torch.gather(position_ids + 1, 1, order))
    return trie, kv_stable
