"""EAGLE-3 draft-head training (port of `hsd_tpu/train/eagle3.py`), the
counterpart of the reference's DeepSpeed pipeline
(`EAGLE-3H/eagle/traineagle3/`):

  * the frozen target's forward, under `torch.no_grad()`, gives the
    three-layer feature stream and the soft targets (dataprepare,
    traineagle3/cnets.py:691-709); its quantized products reach the hand
    kernels, which have no backward and never see a tensor that needs one;
  * the head trains through `steps` (default 7) chained prediction steps:
    at step s the attention sees the step-0 keys causally (with s banned
    diagonals) plus the position-aligned keys of steps 1..s, the
    reference's cache_hidden attention (traineagle3/cnets.py:243-322);
  * per-step soft cross-entropy against the target's distribution over the
    draft vocabulary via d2t / t2d (traineagle3/cnets.py:762-841);
  * the optimizer is optax's chain as the JAX package builds it:
    `clip_by_global_norm(grad_clip)` in optax's form (`g` kept below the
    norm, else `g / norm * max`; torch's `clip_grad_norm_` adds 1e-6 to
    the norm), then `torch.optim.AdamW` (b1 0.9, b2 0.95, eps 1e-8, weight
    decay on every trainable leaf, the norms included) under a `LambdaLR`
    that is `optax.warmup_cosine_decay_schedule(0, lr, warmup_steps,
    total_steps)` read at the pre-increment count: step 0 has lr 0, and
    `total_steps` counts the warmup. A trainable leaf the loss does not
    reach gets a zero gradient, so it decays as optax decays it;
  * checkpoints are `torch.save` files in the `state_N` directories the JAX
    package writes with orbax (auto-resume by the same regex); neither
    package reads the other's files.

The step takes no mesh: data parallelism and the ZeRO-style sharding of
the Adam moments (`zero_mesh`, `zero_opt_shardings`) come with the port's
`parallel/`. The state is a mutable `TrainState`: the optimizer updates the
head's leaves in place, and every step function returns the state it was
given.
"""
from __future__ import annotations

import dataclasses
import math
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..engine.kvcache import init_cache
from ..models import transformer
from ..models.eagle import EagleConfig, EagleParams
from ..ops.linear import apply_linear, rms_norm
from .data import as_tensor
from .probes import top_k_accuracy

FROZEN = ("embed", "d2t", "t2d")   # ref cnets.py:24: requires_grad off


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 7            # chained prediction depth (self.length)
    lr: float = 5e-5
    warmup_steps: int = 2000
    total_steps: int = 100_000
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 0.5
    max_len: int = 2048


@dataclasses.dataclass
class TrainState:
    params: EagleParams                 # trainable leaves require grad
    opt: torch.optim.AdamW              # over trainable_leaves(params)
    sched: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def lr_lambda(tc: TrainConfig) -> Callable[[int], float]:
    """`optax.warmup_cosine_decay_schedule(0, 1, warmup_steps, total_steps)`
    at a count: linear from 0 over the warmup, then a cosine to 0 over the
    remaining total_steps - warmup_steps (clamped at its end). Raises as
    optax does when no decay steps remain."""
    warm, decay = tc.warmup_steps, tc.total_steps - tc.warmup_steps
    if decay <= 0:
        raise ValueError(f"total_steps {tc.total_steps} leaves no decay "
                         f"steps after warmup_steps {tc.warmup_steps}")

    def f(count: int) -> float:
        if count < warm:
            return count / warm
        c = min(count - warm, decay)
        return 0.5 * (1.0 + math.cos(math.pi * c / decay))
    return f


def _split_trainable(params: EagleParams):
    """embed / d2t / t2d are frozen buffers (ref: cnets.py:24 requires_grad
    off); v3's fc_b is None and trains nothing."""
    d = params._asdict()
    trainable = {k: v for k, v in d.items() if k not in FROZEN}
    frozen = {k: v for k, v in d.items() if k in FROZEN}
    return trainable, frozen


def _merge(trainable: dict, frozen: dict) -> EagleParams:
    return EagleParams(**{**trainable, **frozen})


def trainable_leaves(params: EagleParams) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every trainable leaf, in the field order."""
    return [(k, v) for k, v in _split_trainable(params)[0].items()
            if v is not None]


def make_optimizer(leaves: List[torch.Tensor], tc: TrainConfig):
    """optax.adamw(warmup_cosine_decay(0, lr, ...), b1, b2, eps 1e-8,
    weight_decay) as (torch.optim.AdamW, LambdaLR); the clip comes before
    it in each step (`clip_by_global_norm_`)."""
    opt = torch.optim.AdamW(leaves, lr=tc.lr, betas=(tc.b1, tc.b2), eps=1e-8,
                            weight_decay=tc.weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda(tc))


def init_train_state(params: EagleParams, tc: TrainConfig) -> TrainState:
    """A fresh state over a copy of the trainable leaves (the caller's
    tensors stay untouched); the frozen buffers are shared."""
    trainable, frozen = _split_trainable(params)
    trainable = {k: None if v is None
                 else v.detach().clone().requires_grad_(True)
                 for k, v in trainable.items()}
    params = _merge(trainable, frozen)
    opt, sched = make_optimizer([v for _, v in trainable_leaves(params)], tc)
    return TrainState(params=params, opt=opt, sched=sched, step=0)


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """optax.clip_by_global_norm in place: the norm over every gradient (f32
    sums), each gradient kept where the norm is below max_norm, else
    g / norm * max_norm. Returns the norm."""
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def apply_update(state: TrainState, tc: TrainConfig,
                 loss: torch.Tensor, metrics: Dict[str, torch.Tensor]
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Backward of `loss`, the clip, one AdamW step under the schedule, and
    the step count; returns (state, metrics with "loss")."""
    leaves = [v for _, v in trainable_leaves(state.params)]
    state.opt.zero_grad(set_to_none=True)
    loss.backward()
    for p in leaves:             # optax decays a leaf the loss misses too
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    clip_by_global_norm_([p.grad for p in leaves], tc.grad_clip)
    state.opt.step()
    state.sched.step()
    state.step += 1
    out = {k: v.detach() for k, v in metrics.items()}
    out["loss"] = loss.detach()
    return state, out


def training_rope(x: torch.Tensor, positions: torch.Tensor,
                  theta: float) -> torch.Tensor:
    """The training forward's own NeoX RoPE (`eagle3.py:146-153` of the JAX
    package): plain `theta` frequencies. It ignores `rope_scaling`, which
    serving's `head_forward` applies; the port keeps that as the
    reference has it. x [B, T, H, hd], positions [1 or B, T]."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, -1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def _shift(t: torch.Tensor) -> torch.Tensor:
    """Left by one along dim 1, zero-filled (padding(left=False))."""
    return torch.cat([t[:, 1:], torch.zeros_like(t[:, :1])], 1)


def multi_step_head_loss(ecfg: EagleConfig, params: EagleParams,
                         features: torch.Tensor, target_logits: torch.Tensor,
                         input_ids: torch.Tensor, loss_mask: torch.Tensor,
                         steps: int) -> Tuple[torch.Tensor, dict]:
    """The reference's multi-step training forward (traineagle3/cnets.py:
    713-850).

    features: [B, T, 3*Dt] target feature stream (positions 0..T-1);
    target_logits: [B, T, V] target logits ALREADY shifted left by one
      (dataprepare's padding(left=False)); no gradient flows into them;
    input_ids: [B, T] tokens shifted left by one;
    loss_mask: [B, T].
    The target's argmax and its draft-vocabulary logits are read once and
    shifted each step, which gives what shifting the full logits gives
    (a zero row's argmax is 0, its draft logits zeros).
    """
    B, T, _ = features.shape
    H, Hkv, hd = ecfg.num_heads, ecfg.num_kv_heads, ecfg.head_dim
    Vd = ecfg.draft_vocab_size
    eps = ecfg.rms_norm_eps
    dev = features.device
    scale = hd ** -0.5

    hidden = apply_linear(params.fc, features.to(ecfg.dtype))
    # draft-vocab gather indices: target id of draft slot j is j + d2t[j]
    dv_ids = torch.arange(Vd, device=dev) + params.d2t.long()
    with torch.no_grad():
        tgt_f = target_logits.float()
        tgt_max = torch.argmax(tgt_f, -1)                 # [B, T]
        tgt_draft = tgt_f.index_select(-1, dv_ids)        # [B, T, Vd]
        del tgt_f

    mask0 = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
    pos = torch.arange(T, device=dev)[None, :]
    rep = H // Hkv
    cache_k, cache_v = [], []
    losses, accs = [], []
    ids, lm = input_ids.long(), loss_mask.float()
    topk = {}

    for s in range(steps):
        emb = params.embed[ids].to(ecfg.dtype)
        x = torch.cat([rms_norm(emb, params.ln_input, eps),
                       rms_norm(hidden, params.ln_hidden, eps)], -1)
        q = apply_linear(params.wq, x).reshape(B, T, H, hd)
        k = apply_linear(params.wk, x).reshape(B, T, Hkv, hd)
        v = apply_linear(params.wv, x).reshape(B, T, Hkv, hd)
        q = training_rope(q, pos + s, ecfg.rope_theta)
        k = training_rope(k, pos + s, ecfg.rope_theta)
        cache_k.append(k.repeat_interleave(rep, dim=2))
        cache_v.append(v.repeat_interleave(rep, dim=2))

        # scores vs step-0 keys (causal with banned diagonals)...
        s0 = torch.einsum("bthd,bshd->bhts", q.float(),
                          cache_k[0].float()) * scale
        cols = [torch.where(mask0, s0, -1e30)]
        # ...plus the position-aligned keys of steps 1..s
        for i in range(1, s + 1):
            si = torch.sum(q * cache_k[i], -1) * scale          # [B, T, H]
            cols.append(si.transpose(1, 2)[..., None].float())  # [B, H, T, 1]
        w = torch.softmax(torch.cat(cols, -1), -1).to(q.dtype)
        att = torch.einsum("bhts,bshd->bthd", w[..., :T], cache_v[0])
        for i in range(1, s + 1):
            wi = w[..., T + i - 1].transpose(1, 2)              # [B, T, H]
            att = att + wi[..., None] * cache_v[i]
        out = hidden + apply_linear(params.wo, att.reshape(B, T, H * hd))
        h2 = rms_norm(out, params.ln_post, eps)
        out = out + apply_linear(params.wdown,
                                 F.silu(apply_linear(params.wgate, h2))
                                 * apply_linear(params.wup, h2))

        logits = apply_linear(params.lm_head,
                              rms_norm(out, params.norm, eps)).float()
        with torch.no_grad():
            pmask = (params.t2d[tgt_max] & (lm > 0)).float()
            tgt_p = torch.softmax(tgt_draft, -1)
        logp = torch.log_softmax(logits, -1)
        loss = -torch.mean(torch.sum(tgt_p * logp, -1) * pmask)
        losses.append(loss)
        with torch.no_grad():
            hit = torch.argmax(logits, -1) == torch.argmax(tgt_p, -1)
            accs.append(torch.sum(hit * pmask) / (torch.sum(lm) + 1e-6))
            if s == 0:
                # top-k probes on the first step's logits (the engine's
                # first-draft position; ref main.py:345-379)
                topk = top_k_accuracy(logits, tgt_draft, pmask)

        if s != steps - 1:
            hidden = out
            ids, lm = _shift(ids), _shift(lm)
            tgt_max, tgt_draft = _shift(tgt_max), _shift(tgt_draft)
            # ban one more diagonal (traineagle3/cnets.py:845-849)
            i0 = torch.arange(T - s, device=dev)
            mask0 = mask0.clone()
            mask0[i0 + s, i0] = False

    metrics = {f"ploss_{i}": l for i, l in enumerate(losses)}
    metrics.update({f"acc_{i}": a for i, a in enumerate(accs)})
    metrics.update(topk)
    return sum(losses), metrics


def _device(state: TrainState) -> torch.device:
    return state.params.lm_head.device


def _as_batch(input_ids, loss_mask, device):
    """numpy or tensor batches -> (int64 ids, f32 mask) on `device`."""
    return (as_tensor(input_ids, device).long(),
            as_tensor(loss_mask, device).float())


@torch.no_grad()
def target_stream(cfg_t: ModelConfig, params_t, input_ids: torch.Tensor,
                  feature_layers) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frozen target over `input_ids` [B, T] in a fresh cache:
    (logits [B, T, V] f32, feature stream), no gradient anywhere."""
    B, T = input_ids.shape
    cache = init_cache(cfg_t, B, T, input_ids.device)
    logits, _, feats = transformer.forward(cfg_t, params_t, input_ids, cache,
                                           feature_layers=feature_layers)
    return logits, feats


@torch.no_grad()
def final_hidden(cfg_t: ModelConfig, params_t,
                 input_ids: torch.Tensor) -> torch.Tensor:
    """The frozen target's final pre-norm hidden state [B, T, D] (the
    EAGLE-1 stream), without gradients; its head is skipped, which the JAX
    package's compiler drops as unused."""
    B, T = input_ids.shape
    hidden, _ = transformer.forward(cfg_t, params_t, input_ids,
                                    init_cache(cfg_t, B, T, input_ids.device),
                                    skip_head=True)
    return hidden


def make_train_step(cfg_t: ModelConfig, ecfg: EagleConfig, tc: TrainConfig,
                    feature_layers: Tuple[int, int, int]):
    """The train step: (state, params_target, input_ids, loss_mask) ->
    (state, metrics). The batch may be numpy or tensors; it runs on the
    head's device."""

    def step(state: TrainState, params_t, input_ids, loss_mask):
        ids, lm = _as_batch(input_ids, loss_mask, _device(state))
        logits, feats = target_stream(cfg_t, params_t, ids, feature_layers)
        tgt = _shift(logits)
        del logits
        loss, metrics = multi_step_head_loss(ecfg, state.params, feats, tgt,
                                             _shift(ids), lm, tc.steps)
        del tgt
        return apply_update(state, tc, loss, metrics)

    return step


def make_train_step_offline(cfg_t: ModelConfig, ecfg: EagleConfig,
                            tc: TrainConfig):
    """Offline-features train step (ref CustomDataset mode,
    train/main.py:133-172): consumes PRE-DUMPED target features + logits
    (train/features.py), with no target forward. Signature matches
    train_loop's dict-batch splat: (state, params_t_ignored, *, input_ids,
    loss_mask, features, target_logits) -> (state, metrics). Shifting is
    the online step's, so online and offline trajectories agree given
    equal data."""
    del cfg_t

    def step(state: TrainState, params_t, *, input_ids, loss_mask,
             features, target_logits):
        del params_t
        dev = _device(state)
        ids, lm = _as_batch(input_ids, loss_mask, dev)
        feats = as_tensor(features, dev).float()
        tgt = _shift(as_tensor(target_logits, dev).float())
        loss, metrics = multi_step_head_loss(ecfg, state.params, feats, tgt,
                                             _shift(ids), lm, tc.steps)
        return apply_update(state, tc, loss, metrics)

    return step


def _state_dir(path: str, step: int) -> str:
    return os.path.join(path, f"state_{step}")


def save_checkpoint(path: str, state: TrainState):
    """`torch.save` of the params (every field but a None fc_b), the
    optimizer's and the scheduler's state_dicts and the step into
    `path/state_{step}/state.pt` (the JAX package's directory layout;
    replaces DeepSpeed save_16bit_model / save_checkpoint,
    traineagle3/main.py:345-347)."""
    d = _state_dir(path, state.step)
    os.makedirs(d, exist_ok=True)
    params = {k: v.detach() for k, v in state.params._asdict().items()
              if v is not None}
    torch.save({"params": params, "opt": state.opt.state_dict(),
                "sched": state.sched.state_dict(), "step": state.step},
               os.path.join(d, "state.pt"))


def latest_checkpoint_step(path: str) -> Optional[int]:
    """Auto-resume discovery (replaces find_max_state_with_file,
    traineagle3/main.py:239-258)."""
    if not os.path.isdir(path):
        return None
    best = None
    for d in os.listdir(path):
        m = re.fullmatch(r"state_(\d+)", d)
        if m:
            best = max(best or 0, int(m.group(1)))
    return best


def restore_checkpoint(path: str, step: int,
                       template: TrainState) -> TrainState:
    """Load `path/state_{step}` into `template` and return it: the trainable
    leaves are written in place (its optimizer keeps holding them), the
    frozen buffers replaced by the checkpoint's."""
    dev = _device(template)
    ck = torch.load(os.path.join(_state_dir(path, step), "state.pt"),
                    map_location=dev, weights_only=True)
    with torch.no_grad():
        for k, v in trainable_leaves(template.params):
            v.copy_(ck["params"][k])
    template.params = template.params._replace(
        **{k: ck["params"][k] for k in FROZEN})
    template.opt.load_state_dict(ck["opt"])
    template.sched.load_state_dict(ck["sched"])
    template.step = int(ck["step"])
    return template
