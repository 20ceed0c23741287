"""EAGLE-1/2 draft-head training, the legacy single-step objective (port of
`hsd_tpu/train/eagle1.py`).

Parity with the reference's accelerate/DeepSpeed trainers
(`EAGLE-3H/eagle/train/main.py:50-469`, `main_deepspeed.py`): the head
predicts the target's NEXT hidden state from (token embedding, current
hidden); losses are

  vloss = SmoothL1(predicted_hidden, target_hidden_next)      (:~270)
  ploss = soft cross-entropy between head(predicted_hidden) and
          head(target_hidden_next) distributions
  total = v_w * vloss + p_w * ploss   (defaults v_w=1.0, p_w=0.1)

The head runs through the port's `head_forward`, whose in-place KV writes
autograd tracks. The optimizer, the state and the checkpoints are the
EAGLE-3 trainer's (train/eagle3.py).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import ModelConfig
from ..models.eagle import (EagleConfig, EagleParams, head_forward,
                            init_eagle_kv)
from ..ops.linear import apply_linear
from .data import as_tensor
from .eagle3 import (Share, TrainConfig, TrainState, _as_batch, _device,
                     apply_update, data_share, final_hidden)
from .probes import top_k_accuracy


def smooth_l1(x, y, beta: float = 1.0):
    d = torch.abs(x - y)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def eagle1_loss(ecfg: EagleConfig, params: EagleParams, hidden: torch.Tensor,
                input_ids: torch.Tensor, loss_mask: torch.Tensor,
                v_w: float = 1.0, p_w: float = 0.1,
                share: Optional[Share] = None):
    """hidden: [B, T, D] target final hidden states; input_ids [B, T];
    the head consumes (emb(ids_{t+1}), hidden_t) and must predict
    hidden_{t+1} (the standard EAGLE-1 shift). share: a data-parallel
    rank's share (train.eagle3.Share): every ratio's denominator is then
    the global batch's, so loss and metrics are this rank's parts."""
    total = (share or Share()).total
    B, T, D = hidden.shape
    dev = hidden.device
    emb = params.embed[input_ids.long()].to(ecfg.dtype)
    # pair (emb of token t+1, hidden t) -> predict hidden t+1
    emb_in = emb[:, 1:]
    hid_in = hidden[:, :-1].to(ecfg.dtype)
    target_h = hidden[:, 1:].detach()
    kv = init_eagle_kv(ecfg, B, T, dev)
    pos = torch.arange(T - 1, device=dev)[None, :].expand(B, T - 1)
    out, _ = head_forward(ecfg, params, emb_in, hid_in, kv, pos)

    lm = loss_mask[:, 1:].float()
    m = lm[..., None]
    vloss = torch.sum(smooth_l1(out.float(), target_h.float()) * m) \
        / (total(torch.sum(m)) * D + 1e-6)
    logits_pred = apply_linear(params.lm_head, out).float()
    with torch.no_grad():
        logits_tgt = apply_linear(params.lm_head,
                                  target_h.to(ecfg.dtype)).float()
        tgt_p = torch.softmax(logits_tgt, -1)
    ploss = -torch.sum(tgt_p * torch.log_softmax(logits_pred, -1), -1)
    ploss = torch.sum(ploss * lm) / (total(torch.sum(lm)) + 1e-6)
    with torch.no_grad():
        hit = torch.argmax(logits_pred, -1) == torch.argmax(logits_tgt, -1)
        acc = torch.sum(hit * lm) / (total(torch.sum(lm)) + 1e-6)
    metrics = {"vloss": vloss, "ploss": ploss, "acc": acc}
    # per-step top-k probes (ref main.py:345-379 top_3acc logging)
    metrics.update(top_k_accuracy(logits_pred, logits_tgt, lm, total=total))
    return v_w * vloss + p_w * ploss, metrics


def make_eagle1_train_step(cfg_t: ModelConfig, ecfg: EagleConfig,
                           tc: TrainConfig, v_w: float = 1.0,
                           p_w: float = 0.1, zero_mesh=None):
    """The legacy head's train step: (state, params_target, input_ids,
    loss_mask) -> (state, metrics), the target's final pre-norm hidden
    state computed without gradients (and without its head). zero_mesh:
    data parallelism, as `eagle3.make_train_step`."""
    share = data_share(zero_mesh)

    def step(state: TrainState, params_t, input_ids, loss_mask):
        ids, lm = _as_batch(input_ids, loss_mask, _device(state))
        ids, lm = share.rows(ids), share.rows(lm)
        hidden = final_hidden(cfg_t, params_t, ids, share.tp_axis)
        loss, metrics = eagle1_loss(ecfg, state.params, hidden, ids, lm,
                                    v_w, p_w, share)
        return apply_update(state, tc, loss, metrics, share)

    return step


def make_eagle1_train_step_offline(cfg_t: ModelConfig, ecfg: EagleConfig,
                                   tc: TrainConfig, v_w: float = 1.0,
                                   p_w: float = 0.1, zero_mesh=None):
    """Offline-features EAGLE-1 step (the reference's ORIGINAL training
    mode: CustomDataset pre-dumped hidden states, train/main.py:133-172):
    (state, params_t_ignored, *, input_ids, loss_mask, hidden) ->
    (state, metrics), with no target forward. zero_mesh: as
    `make_eagle1_train_step`."""
    del cfg_t
    share = data_share(zero_mesh)

    def step(state: TrainState, params_t, *, input_ids, loss_mask, hidden):
        del params_t
        dev = _device(state)
        ids, lm = _as_batch(input_ids, loss_mask, dev)
        ids, lm = share.rows(ids), share.rows(lm)
        hidden = share.rows(as_tensor(hidden, dev)).float()
        loss, metrics = eagle1_loss(ecfg, state.params, hidden, ids, lm,
                                    v_w, p_w, share)
        return apply_update(state, tc, loss, metrics, share)

    return step
