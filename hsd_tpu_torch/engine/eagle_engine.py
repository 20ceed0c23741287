"""EAGLE decode orchestration (port of `hsd_tpu/engine/eagle_engine.py`):

    prefill target (collect the feature stream) -> trie draft
    (models/eagle.py, or a static tree: models/choices.py) -> ONE
    tree-masked target forward over the trie -> trie verification (greedy
    / typical / trie-HSD) -> path KV compaction -> next trie.

As in the JAX package: the head re-absorbs a FIXED window of (feature,
token) pairs each block, and a feature buffer keeps the target features of
every committed position, updated from the accepted tree path.

The JAX package vmaps its single-slot closures over the slots of a pool;
here the slot axis is written out, so `absorb_window` and `commit` take B
rows at once and the single-request generate is the B = 1 case. Per-row
frontiers are device tensors; the single-request loop syncs with the host
once per block (the loop's exit test), the pool once per step (the
server's).
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import EngineConfig, ModelConfig
from ..models import transformer
from ..models.choices import StaticTree, build_static_trie
from ..models.eagle import (EagleConfig, EagleParams, absorb, build_trie,
                            gather_rows, init_eagle_kv)
from ..ops.sampling import processor, sample
from ..verify.trie import (verify_trie_greedy, verify_trie_hsd,
                           verify_trie_typical)
from .kvcache import compact_path, compact_path_staged, init_cache


class EagleGenerateResult(NamedTuple):
    tokens: torch.Tensor       # [S] committed tokens incl. the (padded) prompt
    length: int
    prompt_len: int
    blocks: int
    accepts: torch.Tensor      # [max_blocks] accept length per block (-1 unused)
    draft_lens: torch.Tensor   # [max_blocks] drafted tokens per block (N)
    ncommit: int
    path_lens: torch.Tensor    # [max_blocks] valid length of the best path row


def default_feature_layers(cfg: ModelConfig) -> Tuple[int, int, int]:
    """The reference taps target layer inputs {2, L//2, L-3}
    (modeling_llama_kv.py:1138)."""
    L = cfg.num_layers
    return (min(2, L - 1), L // 2, max(L - 3, 0))


def _target_forward(cfg_t: ModelConfig, ecfg: EagleConfig, target_forward):
    """`target_forward`, or the plain target with the head's feature
    stream: the final pre-norm hidden state for EAGLE-1/2, the inputs of
    three layers for EAGLE-3."""
    if target_forward is not None:
        return target_forward
    feats = (-1,) if ecfg.version == 1 else default_feature_layers(cfg_t)
    return (lambda p, t, c, ab, pos, lengths=None, staging_at=None,
            last_only=False:
            transformer.forward(cfg_t, p, t, c, attn_bias=ab, positions=pos,
                                feature_layers=feats, lengths=lengths,
                                staging_at=staging_at, last_only=last_only))


def autotune_total_tokens(cfg_t: ModelConfig, ecfg: EagleConfig,
                          engine: EngineConfig, params_t, params_e,
                          prompt: torch.Tensor, prompt_len: int,
                          seed: int = 0, candidates=(23, 47, 59),
                          mode: str = "hsd"):
    """Pick the trie size by timing short generates, as the reference's
    total_token auto-tune does (ea_model.py:143-164): per candidate one
    warm run, then one timed run (host clock, synchronized). Returns (the
    fastest EagleConfig, {candidate: committed tokens per second})."""
    short = dataclasses.replace(engine,
                                max_new_tokens=min(32, engine.max_new_tokens))
    dev = prompt.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    stats = {}
    best, best_tps = None, -1.0
    for tt in candidates:
        ecfg_c = dataclasses.replace(ecfg, total_tokens=tt)
        gen = make_eagle_generate(cfg_t, ecfg_c, short, mode=mode)
        gen(params_t, params_e, prompt, prompt_len,
            torch.Generator(device=dev).manual_seed(seed))
        sync()
        t0 = time.perf_counter()
        res = gen(params_t, params_e, prompt, prompt_len,
                  torch.Generator(device=dev).manual_seed(seed + 1))
        sync()
        tps = res.ncommit / (time.perf_counter() - t0)
        stats[tt] = tps
        if tps > best_tps:
            best, best_tps = ecfg_c, tps
    return best, stats


def make_eagle_block(cfg_t: ModelConfig, ecfg: EagleConfig,
                     engine: EngineConfig, mode: str = "hsd",
                     target_forward=None,
                     static_tree: Optional[StaticTree] = None):
    """The reusable pieces of the eagenerate loop: returns `(prefill, block,
    absorb_window, commit)`, shared by `make_eagle_generate` (a loop around
    `block`), `make_eagle_pool` (absorb and commit around ONE slot-batched
    target forward) and `engine.eagle_server.EagleSlotEngine`.

    prefill(params_t, params_e, prompt [P], prompt_len, generator)
        -> (tokens [1, S], length [1], tcache, ekv, feat_buf [1, S, Dt])
    block(params_t, params_e, tokens, length, tcache, ekv, feat_buf,
          generator) -> (tokens, new_length, acc_len, path_len, hit_eos,
          tcache, ekv, feat_buf), one slot (B = 1), tcache.length a host int
    with S = P + max_new_tokens + total_tokens + 2.

    target_forward: optional `(params, tokens, cache, attn_bias, positions,
    lengths=None, staging_at=None, last_only=False) -> (logits, cache,
    feats)`, e.g. eval.synthetic.make_coupled_eagle_target; the prefill
    passes last_only=True and reads logits[:, -1]. Without one, the plain
    target runs with the head's feature stream (`_target_forward`).
    static_tree: draft a fixed choice tree (models/choices.py) in place of
    the beam trie; pass ecfg = choices.eagle_config_for_tree(ecfg, tree)."""
    if static_tree is not None and (
            (static_tree.num_nodes, static_tree.depth)
            != (ecfg.total_tokens, ecfg.depth)):
        raise ValueError("pass ecfg = choices.eagle_config_for_tree(ecfg, "
                         "static_tree)")
    if mode not in ("greedy", "typical", "hsd", "hsd_ref"):
        raise ValueError(f"unknown mode {mode!r}")
    N = ecfg.total_tokens
    depth = ecfg.depth
    Lpath = depth + 2
    T_abs = Lpath                       # head absorb window per block
    temp = processor(engine.temperature, engine.top_k, engine.top_p)
    max_new = engine.max_new_tokens
    eos = cfg_t.eos_token_id
    tfwd = _target_forward(cfg_t, ecfg, target_forward)

    def prefill(params_t, params_e: EagleParams, prompt: torch.Tensor,
                prompt_len: int, generator: Optional[torch.Generator]):
        dev = prompt.device
        P = prompt.shape[0]
        S = P + max_new + N + 2
        start = torch.full((1,), P - int(prompt_len), dtype=torch.int64,
                           device=dev)
        tcache = init_cache(cfg_t, 1, S, dev).replace(start=start)
        scratch = max(depth * ecfg.top_k, N) + T_abs
        ekv = init_eagle_kv(ecfg, 1, S + scratch, dev)
        ekv = ekv._replace(start=start.clone())
        pos0 = torch.clamp(torch.arange(P, device=dev)[None] - start[:, None],
                           min=0)
        # the JAX prefill adds a zero [P, P] bias: no bias is the same sum;
        # it computes every position's logits and samples from the last
        logits, tcache, feats = tfwd(params_t, prompt[None], tcache, None,
                                     pos0, last_only=True)
        feat_buf = torch.zeros((1, S, feats.shape[-1]), dtype=ecfg.dtype,
                               device=dev)
        feat_buf[:, :P] = feats.to(ecfg.dtype)
        root = sample(temp(logits[:, -1]), generator)
        tokens = torch.zeros((1, S), dtype=torch.int64, device=dev)
        tokens[0, :P] = prompt
        tokens[:, P] = root
        length = torch.full((1,), P + 1, dtype=torch.int64, device=dev)
        # head prefill absorb: pairs (feature_j, token_{j+1})
        _, ekv = absorb(ecfg, params_e, feat_buf[:, :P - 1], tokens[:, 1:P],
                        ekv, torch.zeros((1,), dtype=torch.int64, device=dev))
        return tokens, length, tcache, ekv, feat_buf

    def absorb_window(params_e, ekv, feat_buf, tokens, upto):
        """Re-feed the last T_abs (feature, token) pairs of every row so the
        head KV holds pairs 0..upto-1 (the reference's stable_kv catch-up,
        cnets.py:690-696, with a fixed window), then beam out the trie."""
        S = tokens.shape[1]
        s0 = torch.clamp(upto - T_abs, min=0)
        idx = s0[:, None] + torch.arange(T_abs, device=tokens.device)[None]
        fwin = gather_rows(feat_buf, torch.clamp(idx, 0, S - 1))
        twin = torch.gather(tokens, 1, torch.clamp(idx + 1, 0, S - 1))
        root = torch.gather(tokens, 1, torch.clamp(idx[:, -1:] + 1, 0,
                                                   S - 1))[:, 0]
        ekv = ekv._replace(length=s0)
        if static_tree is not None:
            return build_static_trie(ecfg, params_e, fwin, twin, ekv, s0,
                                     root, static_tree)
        return build_trie(ecfg, params_e, fwin, twin, ekv, s0, root)

    def commit(trie, probs, tfeats, tokens, length, feat_buf,
               generator: Optional[torch.Generator]):
        """Verify each row's trie against `probs` [B, N+1, V], commit the
        accepted path and the sampled next token into `tokens` and
        `feat_buf`, and return the compaction selector."""
        B, S = tokens.shape
        dev = tokens.device
        bi = torch.arange(B, device=dev)
        ri = trie.retrieve_indices                       # [B, R, Lpath]
        R = ri.shape[1]
        cand = torch.where(ri >= 0, torch.gather(
            trie.draft_tokens, 1, torch.clamp(ri, 0, N).reshape(B, R * Lpath)
        ).reshape(B, R, Lpath), -1)
        # (probs, ri): the verifiers gather node rows on demand instead of
        # materializing the [R, Lpath, V] path rows
        p_paths = (probs, ri)
        if mode == "greedy":
            best, acc_len, sample_p = verify_trie_greedy(cand, p_paths)
        elif mode == "typical":
            best, acc_len, sample_p = verify_trie_typical(
                cand, p_paths, generator=generator)
        else:
            best, acc_len, sample_p = verify_trie_hsd(
                cand, p_paths, generator=generator,
                frontier="raw" if mode == "hsd_ref" else "capped")

        path = cand[bi, best]                            # [B, Lpath]
        ncommit = acc_len + 1                            # path tokens used
        posn = torch.arange(S, device=dev)[None]
        src = torch.gather(path, 1, torch.clamp(posn - (length[:, None] - 1),
                                                0, Lpath - 1))
        write = (posn >= length[:, None]) & (posn < (length - 1
                                                     + ncommit)[:, None])
        tokens = torch.where(write, src, tokens)
        nxt = sample(sample_p, generator)
        new_length = length - 1 + ncommit + 1
        tokens[bi, torch.clamp(new_length - 1, 0, S - 1)] = nxt

        sel = torch.where(torch.arange(Lpath, device=dev)[None]
                          < ncommit[:, None],
                          torch.clamp(ri[bi, best], 0, N), -1)
        # accepted features into the buffer at [length-1, length-1+ncommit)
        fsel = gather_rows(tfeats, torch.clamp(sel, 0, N))
        fbase = (length - 1)[:, None]
        fwrite = (posn >= fbase) & (posn < fbase + ncommit[:, None])
        fsrc = gather_rows(fsel, torch.clamp(posn - fbase, 0, Lpath - 1)
                            .expand(B, S))
        feat_buf = torch.where(fwrite[..., None], fsrc.to(feat_buf.dtype),
                               feat_buf)
        hit_eos = torch.any(write & (tokens == eos), 1) | (nxt == eos)
        return (tokens, new_length, acc_len,
                trie.path_len[bi, best], hit_eos, sel, ncommit, feat_buf)

    def block(params_t, params_e: EagleParams, tokens, length, tcache, ekv,
              feat_buf, generator: Optional[torch.Generator]):
        trie, ekv = absorb_window(params_e, ekv, feat_buf, tokens, length - 1)
        bias = torch.where(trie.tree_mask, 0.0, -1e30)
        base = tcache.length
        pos = trie.position_ids + (length - 1 - tcache.start)[:, None]
        tlogits, tcache, tfeats = tfwd(params_t, trie.draft_tokens, tcache,
                                       bias, pos)
        probs = temp(tlogits)                            # [1, N+1, V]
        (tokens, new_length, acc_len, plen, hit_eos, sel, ncommit,
         feat_buf) = commit(trie, probs, tfeats, tokens, length, feat_buf,
                            generator)
        tcache = compact_path(tcache, sel[0], int(ncommit[0]), base)
        return (tokens, new_length, acc_len, plen, hit_eos, tcache, ekv,
                feat_buf)

    return prefill, block, absorb_window, commit


def make_eagle_pool(cfg_t: ModelConfig, ecfg: EagleConfig,
                    engine: EngineConfig, mode: str = "hsd",
                    target_forward=None,
                    static_tree: Optional[StaticTree] = None):
    """Slot-BATCHED eagenerate block: one step for a whole pool of B slots
    with ONE target tree forward over the stacked tries, so the quantized
    products see B * (N+1) rows and stream each weight once (8 slots x 60
    tokens = 480 rows: the bf16 tensor-core regime of K7).

    The tree block is STAGED: the forward writes all B tries at the cache's
    fixed tail [S_tok, S_tok + N+1), one uniform write per layer, and
    compaction copies each slot's accepted path from there into its own
    frontier (`kvcache.compact_path_staged`). The pool cache is therefore
    N+1 slots longer than the token buffer.

    Returns `pool_block(params_t, params_e, tokens [B, S], lengths [B],
    tcache (batch-B KVCache, max_len S + N+1), ekv (batch B), feat_buf
    [B, S, Dt], generator) -> (tokens, lengths', acc_len [B], path_len [B],
    hit_eos [B], tcache, ekv, feat_buf)`, with the single-slot block's
    per-slot math (shared `absorb_window` / `commit`)."""
    N = ecfg.total_tokens
    _, _, absorb_window, commit = make_eagle_block(
        cfg_t, ecfg, engine, mode=mode, target_forward=target_forward,
        static_tree=static_tree)
    temp = processor(engine.temperature, engine.top_k, engine.top_p)
    tfwd = _target_forward(cfg_t, ecfg, target_forward)

    def pool_block(params_t, params_e: EagleParams, tokens, lengths, tcache,
                   ekv, feat_buf, generator: Optional[torch.Generator]):
        staging_at = tcache.max_len - (N + 1)
        if staging_at != tokens.shape[1]:
            raise ValueError(
                f"pool cache (max_len={tcache.max_len}) must extend the "
                f"token buffer (S={tokens.shape[1]}) by the staging region "
                f"(N+1={N + 1})")
        trie, ekv = absorb_window(params_e, ekv, feat_buf, tokens,
                                  lengths - 1)
        bias = torch.where(trie.tree_mask, 0.0, -1e30)
        base = lengths - 1     # the cache holds length-1 committed keys
        pos = trie.position_ids + (base - tcache.start)[:, None]
        tlogits, tcache, tfeats = tfwd(params_t, trie.draft_tokens, tcache,
                                       bias, pos, lengths=base,
                                       staging_at=staging_at)
        probs = temp(tlogits)                            # [B, N+1, V]
        (tokens, new_lengths, acc_len, plen, hit_eos, sel, ncommit,
         feat_buf) = commit(trie, probs, tfeats, tokens, lengths, feat_buf,
                            generator)
        tcache = compact_path_staged(tcache, sel, ncommit, base,
                                     src_base=staging_at)
        return (tokens, new_lengths, acc_len, plen, hit_eos, tcache, ekv,
                feat_buf)

    return pool_block


def make_eagle_generate(cfg_t: ModelConfig, ecfg: EagleConfig,
                        engine: EngineConfig, mode: str = "hsd",
                        target_forward=None,
                        static_tree: Optional[StaticTree] = None):
    """Build `generate(params_target, eagle_params, prompt, prompt_len,
    generator) -> EagleGenerateResult` for mode in {'greedy', 'typical',
    'hsd', 'hsd_ref'}. prompt: [P] int64 on the device, left-padded.
    static_tree: a fixed choice tree (see make_eagle_block)."""
    N = ecfg.total_tokens
    max_new = engine.max_new_tokens
    eos = cfg_t.eos_token_id
    prefill_fn, block_fn, _, _ = make_eagle_block(
        cfg_t, ecfg, engine, mode=mode, target_forward=target_forward,
        static_tree=static_tree)

    def generate(params_t, params_e: EagleParams, prompt: torch.Tensor,
                 prompt_len: int, generator: Optional[torch.Generator] = None
                 ) -> EagleGenerateResult:
        P = prompt.shape[0]
        S = P + max_new + N + 2
        tokens, length_t, tcache, ekv, feat_buf = prefill_fn(
            params_t, params_e, prompt, prompt_len, generator)
        length, done = P + 1, False
        accepts, plens = [], []
        while (not done and length + N + 2 <= S and len(accepts) < max_new
               and length - P < max_new):
            (tokens, length_t, acc_len, plen, hit_eos, tcache, ekv,
             feat_buf) = block_fn(params_t, params_e, tokens, length_t,
                                  tcache, ekv, feat_buf, generator)
            # the block's one host sync
            info = torch.cat([length_t, acc_len, plen,
                              hit_eos.to(torch.int64)]).tolist()
            length, done = info[0], bool(info[3])
            accepts.append(info[1])
            plens.append(info[2])

        length = min(length, P + max_new)
        host = tokens[0, :length].tolist()
        for i in range(P, length):
            if host[i] == eos:
                length = i + 1
                break
        blocks = len(accepts)
        acc = torch.full((max_new,), -1, dtype=torch.int64)
        acc[:blocks] = torch.tensor(accepts, dtype=torch.int64)
        pl = torch.full((max_new,), -1, dtype=torch.int64)
        pl[:blocks] = torch.tensor(plens, dtype=torch.int64)
        dl = torch.full((max_new,), -1, dtype=torch.int64)
        dl[:blocks] = N
        return EagleGenerateResult(tokens=tokens[0], length=length,
                                   prompt_len=P, blocks=blocks, accepts=acc,
                                   draft_lens=dl, ncommit=length - P,
                                   path_lens=pl)

    return generate
