"""Static choice-tree drafting, the EAGLE-1 legacy path (port of
`hsd_tpu/models/choices.py`).

A `choices` list of rank-paths (e.g. `[0, 1]`: the rank-1 child of the
rank-0 child of the root) fixes the tree's topology, so every buffer that
the dynamic `build_trie` computes per block (ancestor closure, depths,
retrieve paths) is computed once on the host, in numpy, by
`build_tree_buffers` (the reference's generate_tree_buffers,
eagle/model/utils.py:90-208). At run time `build_static_trie` only fills in
the tokens: one head forward per level over all of that level's nodes, for
every row of the batch at once. The result is the same `Trie` that the
engines and the trie verifiers consume.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .eagle import (EagleConfig, EagleKV, EagleParams, Trie, absorb,
                    draft_logp, head_forward)

# The published Medusa/EAGLE-1 sparse choice tree for 7B models: the 25-node
# prefix the reference ships as mc_sim_7b_63 (choices.py:1).
mc_sim_7b_63: List[List[int]] = [
    [0], [1], [2], [3],
    [0, 0], [0, 1], [0, 2], [1, 0], [1, 1], [2, 0], [2, 1], [3, 0],
    [0, 0, 0], [0, 0, 1], [0, 0, 2], [0, 1, 0], [0, 1, 1], [0, 2, 0],
    [0, 2, 1], [1, 0, 0],
    [0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 0, 2],
    [0, 0, 0, 0, 0], [0, 0, 0, 0, 1],
]


@dataclasses.dataclass(frozen=True)
class StaticTree:
    """Host buffers of a static choice tree (generate_tree_buffers)."""

    choices: Tuple[Tuple[int, ...], ...]   # sorted by (len, lex)
    num_nodes: int                         # N (excluding the root)
    depth: int                             # longest path
    top_k: int                             # largest child rank + 1
    parents: np.ndarray                    # [N+1] int32; root -1
    tree_mask: np.ndarray                  # [N+1, N+1] bool ancestor closure
    position_ids: np.ndarray               # [N+1] int32 node depth
    retrieve_indices: np.ndarray           # [N+1, depth+2] int32, -1 pad
    path_len: np.ndarray                   # [N+1] int32
    num_paths: int                         # leaf count
    level_nodes: Tuple[Tuple[int, ...], ...]       # 1-based ids per level
    level_parent_pos: Tuple[Tuple[int, ...], ...]  # parent's index in its level
    level_rank: Tuple[Tuple[int, ...], ...]        # child rank under the parent


def build_tree_buffers(choices: Sequence[Sequence[int]]) -> StaticTree:
    """The static tree's buffers, in the engine's Trie conventions (root =
    node 0, -1 tail padding): nodes sorted by (depth, lexicographic), the
    ancestor closure with every node attending the root, depth positions,
    and root-first leaf paths sorted lexicographically."""
    sc = sorted((tuple(c) for c in choices), key=lambda c: (len(c), c))
    if len(set(sc)) != len(sc):
        raise ValueError("duplicate choices")
    N = len(sc)
    depth = max(len(c) for c in sc)
    top_k = max(c[-1] for c in sc) + 1
    index = {c: i + 1 for i, c in enumerate(sc)}

    parents = np.full((N + 1,), -1, np.int32)
    for c, i in index.items():
        if len(c) > 1 and c[:-1] not in index:
            raise ValueError(f"orphan choice {c}")
        parents[i] = 0 if len(c) == 1 else index[c[:-1]]

    tree_mask = np.zeros((N + 1, N + 1), bool)
    tree_mask[0, 0] = True
    position_ids = np.zeros((N + 1,), np.int32)
    for c, i in index.items():
        tree_mask[i] = tree_mask[parents[i]]
        tree_mask[i, i] = True
        position_ids[i] = len(c)

    is_parent = np.zeros((N + 1,), bool)
    is_parent[parents[1:]] = True
    leaves = [i for i in range(1, N + 1) if not is_parent[i]]

    Lp = depth + 2
    retrieve = np.full((N + 1, Lp), -1, np.int32)
    plen = np.zeros((N + 1,), np.int32)
    rows = []
    for i in leaves:
        path, cur = [], i
        while cur > 0:
            path.append(cur)
            cur = parents[cur]
        rows.append([0] + path[::-1])
    big = N + 5
    rows.sort(key=lambda r: r + [big] * (Lp - len(r)))
    for j, r in enumerate(rows):
        retrieve[j, :len(r)] = r
        plen[j] = len(r)

    level_nodes, level_parent_pos, level_rank = [], [], []
    for lvl in range(depth):
        nodes = [index[c] for c in sc if len(c) == lvl + 1]
        if lvl == 0:
            ppos = [0] * len(nodes)
        else:
            prev = {n: j for j, n in enumerate(level_nodes[lvl - 1])}
            ppos = [prev[parents[n]] for n in nodes]
        level_nodes.append(tuple(nodes))
        level_parent_pos.append(tuple(ppos))
        level_rank.append(tuple(sc[n - 1][-1] for n in nodes))

    return StaticTree(choices=tuple(sc), num_nodes=N, depth=depth,
                      top_k=top_k, parents=parents, tree_mask=tree_mask,
                      position_ids=position_ids, retrieve_indices=retrieve,
                      path_len=plen, num_paths=len(leaves),
                      level_nodes=tuple(level_nodes),
                      level_parent_pos=tuple(level_parent_pos),
                      level_rank=tuple(level_rank))


def eagle_config_for_tree(base: EagleConfig, tree: StaticTree) -> EagleConfig:
    """The EagleConfig shape parameters of a static tree."""
    return dataclasses.replace(base, depth=tree.depth,
                               total_tokens=tree.num_nodes,
                               top_k=max(base.top_k, tree.top_k))


def build_static_trie(cfg: EagleConfig, p: EagleParams,
                      target_features: torch.Tensor, tokens: torch.Tensor,
                      kv: EagleKV, prefix_len: torch.Tensor,
                      root_token: torch.Tensor, tree: StaticTree
                      ) -> Tuple[Trie, EagleKV]:
    """Fill the static tree of every row with head-drafted tokens.

    The contract of models.eagle.build_trie ([B] rows), with the topology
    and its buffers taken from `tree`: after the absorb, one head forward
    per level over the level's nodes, node i (1-based) writing its KV at
    trie slot base + i - 1 and attending its prefix and its ancestors."""
    N, depth = tree.num_nodes, tree.depth
    if (cfg.total_tokens, cfg.depth) != (N, depth):
        raise ValueError("use eagle_config_for_tree to match the engine's "
                         "shapes to the tree")
    B, T = tokens.shape
    dev = tokens.device
    out_hidden, kv = absorb(cfg, p, target_features, tokens, kv, prefix_len)
    last_hidden = out_hidden[:, -1]                      # [B, D]
    kv_stable = kv
    base_len = kv.length
    D = last_hidden.shape[-1]

    node_tokens = torch.zeros((B, N + 1), dtype=torch.int64, device=dev)
    node_tokens[:, 0] = root_token
    node_hidden = torch.zeros((B, N + 1, D), dtype=last_hidden.dtype,
                              device=dev)
    node_hidden[:, 0] = last_hidden

    # level-0 candidates come from the absorbed root state
    top_i = torch.topk(draft_logp(cfg, p, last_hidden), tree.top_k,
                       dim=-1).indices
    top_t = top_i + p.d2t[top_i]
    n0 = list(tree.level_nodes[0])
    node_tokens[:, n0] = top_t[:, list(tree.level_rank[0])]
    node_hidden[:, n0] = last_hidden[:, None]

    S = kv.k.shape[1]
    slot = torch.arange(S, device=dev)[None, :]
    prefix_mask = (slot < base_len[:, None]) & (slot >= kv.start[:, None])
    trie_idx = slot - base_len[:, None]                  # [B, S]
    in_trie = (trie_idx >= 0) & (trie_idx < N)
    closure = torch.from_numpy(tree.tree_mask[:, 1:]).to(dev)  # [N+1, N]
    kvk = kv
    # the deepest level has no children: its nodes are never fed
    for lvl in range(depth - 1):
        nodes = list(tree.level_nodes[lvl])
        W = len(nodes)
        anc = closure[nodes][None].expand(B, W, N)
        idx = torch.clamp(trie_idx, 0, N - 1)[:, None, :].expand(B, W, S)
        anc_mask = torch.gather(anc, 2, idx) & in_trie[:, None, :]
        mask = prefix_mask[:, None, :] | anc_mask         # [B, W, S]
        emb_t = p.embed[node_tokens[:, nodes]].to(cfg.dtype)
        posb = (prefix_len + T + lvl - kvk.start)[:, None].expand(B, W)
        kv_in = EagleKV(kvk.k, kvk.v, base_len + nodes[0] - 1, kvk.start)
        out, kvk = head_forward(cfg, p, emb_t, node_hidden[:, nodes], kv_in,
                                posb, mask)
        ctop = torch.topk(draft_logp(cfg, p, out), tree.top_k,
                          dim=-1).indices                 # [B, W, top_k]
        ctop = ctop + p.d2t[ctop]
        child = list(tree.level_nodes[lvl + 1])
        ppos = list(tree.level_parent_pos[lvl + 1])
        node_tokens[:, child] = ctop[:, ppos, list(tree.level_rank[lvl + 1])]
        node_hidden[:, child] = out[:, ppos]

    rep = lambda a, dtype: torch.from_numpy(a).to(dev, dtype)[None].expand(
        (B,) + a.shape)
    trie = Trie(draft_tokens=node_tokens,
                parents=rep(tree.parents, torch.int64),
                tree_mask=rep(tree.tree_mask, torch.bool),
                position_ids=rep(tree.position_ids, torch.int64),
                retrieve_indices=rep(tree.retrieve_indices, torch.int64),
                num_paths=torch.full((B,), tree.num_paths, dtype=torch.int64,
                                     device=dev),
                path_len=rep(tree.path_len, torch.int64))
    return trie, kv_stable
