"""Training-time quality probes for the EAGLE draft head (port of
`hsd_tpu/train/probes.py`).

Re-derivations of the reference trainer's diagnostics
(EAGLE-3H/eagle/train/main.py):

  * `top_k_accuracy` — fraction of masked positions whose target-argmax token
    is inside the head's top-k prediction (main.py:345-379, `top_accuracy`
    at :216-229);
  * `getkacc` — k-step greedy ROLLOUT accuracy: from a committed prefix the
    head rolls out `max_length` tokens feeding back its own hidden outputs,
    and kacc_k is the fraction of rollouts whose first k+1 tokens all match
    the frozen target's argmax chain (main.py:241-292). This is the probe
    that predicts block efficiency before any engine run.

As in the JAX package, ONE causal forward computes every prefix's step-0
state, and the rollouts of all sampled prefixes advance in lockstep as batch
rows: each probe writes its rollout KV into a shared scratch region past the
T - 1 prefix pairs and masks the prefix to its own length, so the probe is
`max_length` batched head forwards however many prefixes are tested. The
JAX scan over rollout steps is a loop here, with the same layout.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..engine.eagle_engine import default_feature_layers
from ..models.eagle import (EagleConfig, EagleKV, EagleParams, head_forward,
                            init_eagle_kv)
from ..ops.linear import apply_linear
from .data import as_tensor


def top_k_accuracy(logits_pred: torch.Tensor, logits_tgt: torch.Tensor,
                   loss_mask: torch.Tensor, ks: Sequence[int] = (1, 2, 3),
                   total=None):
    """Per-k accuracies over masked positions (ref main.py:216-229,345-379).

    logits_pred/logits_tgt: [..., V]; loss_mask broadcastable to the leading
    dims. Returns {f'top{k}_acc': 0-d tensor}. total: maps the mask's local
    sum to the global batch's (a data-parallel rank's part,
    train.eagle3.Share.total)."""
    with torch.no_grad():
        tgt = torch.argmax(logits_tgt, -1)
        topi = torch.topk(logits_pred, max(ks), dim=-1).indices   # [..., kmax]
        hit = topi == tgt[..., None]
        m = loss_mask.float()
        denom = (torch.sum(m) if total is None
                 else total(torch.sum(m))) + 1e-6
        return {f"top{k}_acc": torch.sum(torch.any(hit[..., :k], -1) * m)
                / denom for k in ks}


@torch.no_grad()
def _rollout(ecfg: EagleConfig, params: EagleParams, hidden: torch.Tensor,
             input_ids: torch.Tensor, probes: torch.Tensor, max_length: int):
    """Greedy head rollouts from every probe prefix, batched.

    hidden [B, T, D] target hidden states, input_ids [B, T]; probes [Np]
    prefix lengths (1 <= p <= T-1). Returns rolled tokens [B, Np, max_length]
    and the target's argmax ids [B, T-1]: tgt[t] = argmax head(hidden[t+1]).
    """
    B, T, D = hidden.shape
    Np = probes.shape[0]
    dev = hidden.device
    emb = params.embed[input_ids].to(ecfg.dtype)

    # one causal forward over all pairs (emb(ids[t+1]), hidden[t])
    S = T + max_length + 1
    kv = init_eagle_kv(ecfg, B, S, dev)
    pos = torch.arange(T - 1, device=dev)[None, :].expand(B, T - 1)
    out_full, kv_full = head_forward(ecfg, params, emb[:, 1:],
                                     hidden[:, :-1].to(ecfg.dtype), kv, pos)

    def head_ids(h):
        i = torch.argmax(apply_linear(params.lm_head, h).float(), -1)
        return i + params.d2t[i]                          # target-vocab ids

    tgt_ids = head_ids(hidden[:, 1:].to(ecfg.dtype))      # [B, T-1]

    # probe rows: (b, p) -> batch row b * Np + i; prefix pairs [0, p) shared
    # via the repeat, rollout pairs written to scratch slots [T-1+j]
    R = B * Np
    kb = kv_full.k.repeat_interleave(Np, 0)               # [R, S, Hkv, hd]
    vb = kv_full.v.repeat_interleave(Np, 0)
    p_row = probes.repeat(B)                              # [R]
    # step-0 token comes from the full forward's output at pair p-1
    out0 = out_full.repeat_interleave(Np, 0)              # [R, T-1, D]
    h = out0[torch.arange(R, device=dev), p_row - 1]
    tok = head_ids(h[:, None].to(ecfg.dtype))[:, 0]

    slot = torch.arange(S, device=dev)[None, :]
    zeros = torch.zeros((R,), dtype=torch.int64, device=dev)
    toks = []
    for j in range(max_length - 1):
        # pair (emb(tok), h) at absolute position p-1+j+1; KV scratch slot
        # T-1+j; attends prefix pairs [0, p) + scratch pairs [T-1, T-1+j]
        mask = (slot < p_row[:, None]) | \
               ((slot >= T - 1) & (slot <= T - 1 + j))
        kv_in = EagleKV(kb, vb, zeros + (T - 1 + j), zeros)
        posj = (p_row + j)[:, None]
        emb_t = params.embed[tok][:, None].to(ecfg.dtype)
        out, _ = head_forward(ecfg, params, emb_t, h[:, None], kv_in, posj,
                              mask[:, None, :])
        toks.append(tok)
        h = out[:, 0]
        tok = head_ids(h[:, None].to(ecfg.dtype))[:, 0]
    rolled = torch.stack(toks + [tok], 1)                 # [R, max_length]
    return rolled.reshape(B, Np, max_length), tgt_ids


def getkacc(ecfg: EagleConfig, params: EagleParams, hidden: torch.Tensor,
            input_ids, loss_mask, max_length: int = 5, max_probes: int = 16,
            probes: Optional[np.ndarray] = None) -> np.ndarray:
    """k-step rollout accuracy (ref main.py:241-292 `getkacc`).

    Accounting mirrors the reference loop exactly: per (row, prefix), step k
    is counted iff every loss_mask[p..p+k] is set and the chain reached it;
    on the first mismatch all remaining steps count as tested-and-wrong.
    Returns kacc [max_length] floats (NaN-free; 0 where nothing was tested)."""
    B, T, _ = hidden.shape
    dev = hidden.device
    if probes is None:
        hi = max(T - max_length - 1, 2)
        probes = np.unique(np.linspace(1, hi, min(max_probes, hi),
                                       dtype=np.int32))
    ids = as_tensor(input_ids, dev).long()
    rolled, tgt = _rollout(ecfg, params, hidden, ids,
                           as_tensor(np.asarray(probes), dev).long(),
                           max_length)
    rolled = rolled.cpu().numpy()
    tgt = tgt.cpu().numpy()
    lm = as_tensor(loss_mask, "cpu").numpy()
    pr = np.asarray(probes)
    total = np.zeros(max_length, np.int64)
    correct = np.zeros(max_length, np.int64)
    for b in range(B):
        for i, p in enumerate(pr):
            for k in range(max_length):
                if p + k >= T or lm[b, p + k] == 0:
                    break
                total[k] += 1
                if rolled[b, i, k] == tgt[b, p + k - 1]:
                    correct[k] += 1
                else:
                    total[k + 1:] += 1
                    break
    return np.where(total > 0, correct / np.maximum(total, 1), 0.0)


def make_kacc_probe(cfg_t, ecfg: EagleConfig, max_length: int = 5,
                    max_probes: int = 16):
    """Build `probe(params_e, params_t, input_ids, loss_mask) -> kacc` — the
    between-epoch rollout-accuracy probe the reference runs on <=10 test
    batches (main.py:420-424). Computes the frozen target's hidden stream
    (v1: final hidden; v3: fc over the 3-layer feature stream), without
    gradients, on the head's device, and runs `getkacc`."""
    from .eagle3 import final_hidden, target_stream

    feat_layers = default_feature_layers(cfg_t)

    def probe(params_e: EagleParams, params_t, input_ids, loss_mask):
        dev = params_e.lm_head.device
        ids = as_tensor(input_ids, dev).long()
        with torch.no_grad():
            if ecfg.version == 1:
                hidden = final_hidden(cfg_t, params_t, ids)
            else:
                _, feats = target_stream(cfg_t, params_t, ids, feat_layers)
                hidden = apply_linear(params_e.fc, feats.to(ecfg.dtype))
        kacc = getkacc(ecfg, params_e, hidden, ids, loss_mask,
                       max_length=max_length, max_probes=max_probes)
        return {f"kacc_{i}": float(v) for i, v in enumerate(kacc)}

    return probe
