"""Realistic-divergence oracle pair (port of `hsd_tpu/eval/oracle.py`): a
TRAINED tiny target LM + a capacity-limited DISTILLED draft, so that the
p/q-ratio distribution the verifiers see resembles trained model pairs
instead of smooth int8 noise.

Why: the int8-coupled synthetic regime (eval/synthetic.py) matches the
reference's tokenwise BE level (~5.99) but overshoots the published HSD
uplift (+22% vs +5.2%) and inverts the EAGLE typical-vs-HSD ordering. The
divergence SHAPE is wrong: int8 error is a small smooth perturbation applied
uniformly to every position, while a real 0.5B-vs-14B pair diverges in a
concentrated way — near-agreement on low-entropy continuations, real
disagreement at uncertain positions where the small model's capacity runs
out.

This module builds that shape from scratch, on the device, with no
checkpoints:

1. `make_language` — a MIXED-ENTROPY synthetic language (numpy, from an
   int seed: the JAX package seeds the same numpy generator with its key's
   last word, so the same int gives the same language bit for bit):
   multi-token "words" chained by a word-level Markov model with variable
   branching (1..branch_max successors, Zipf-weighted).
2. `train_lm` — next-token CE training of the target oracle.
3. `distill_lm` — soft-CE distillation of a SMALLER draft against the frozen
   target's distribution: the draft's divergence from the target is then a
   capacity gap concentrated at hard positions.
4. `ratio_stats` — p/q diagnostics on draft-sampled continuations:
   per-token acceptance E[min(1, p/q)], the implied tokenwise BE at a given
   gamma, and a log(p/q) histogram.

Calibration knob: `scale_draft_temperature` — a single draft-side logit
temperature (lm_head scaling), tuning the agreement LEVEL while keeping the
trained ratio SHAPE; the target is never touched.

Training runs through the port's own `transformer.forward` (its cache
writes are autograd-tracked in-place copies) under `torch.optim.AdamW`
with a `LambdaLR` that reproduces `optax.warmup_cosine_decay_schedule(0,
lr, max(10, steps // 20), steps)` read at the pre-increment count (step 0
has lr 0), weight decay 0.01 on every parameter, as `optax.adamw` applies
it. The JAX package fuses 300-step chunks into one program (a dispatch
artifact); here it is a plain loop.

Randomness: where the JAX code splits and folds keys, the port draws from
torch.Generators seeded with `ops.sampling.fold_seed`: `train_lm(seed)`
initializes with `init_params(cfg, seed)` and draws its batches, in order,
from `fold_seed(seed, 7)` (JAX: fold_in(key, 7), then fold_in(., step));
`distill_lm` from `fold_seed(seed, 11)`; `sample_tokens` and `ratio_stats`
take a generator and draw from it in order.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..engine.kvcache import init_cache
from ..models import init_params, transformer
from ..models.transformer import ModelParams, resolve_device
from ..ops.linear import QuantizedLinear
from ..ops.sampling import fold_generator, gumbel


class MixedLanguage(NamedTuple):
    words: torch.Tensor    # [n_words, max_wlen] int64 token ids (padded 0)
    wlen: torch.Tensor     # [n_words] int64 word length (1..max_wlen)
    succ: torch.Tensor     # [n_words, branch_max] int64 successor word ids
    slogp: torch.Tensor    # [n_words, branch_max] f32 successor log-probs
                           # (-inf padded)


def make_language(seed: int, vocab: int = 2048, n_words: int = 600,
                  max_wlen: int = 4, branch_max: int = 12,
                  det_frac: float = 0.35, zipf_exp: float = 1.2,
                  device=None) -> MixedLanguage:
    """Host-side construction (numpy; shapes are tiny), on `device` (the
    card unless given).

    - word lengths ~ Zipf capped at max_wlen (most words short);
    - word token ids uniform over [1, vocab) (0 reserved as pad);
    - each word has n_succ successors: `det_frac` of words are
      DETERMINISTIC (1 successor — zero-entropy boundaries exist in real
      text too), the rest have 2..branch_max Zipf-weighted successors drawn
      with popularity skew (low word ids more likely -> realistic reuse).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    wlen = np.minimum(1 + rng.zipf(2.0, n_words), max_wlen).astype(np.int32)
    words = rng.integers(1, vocab, (n_words, max_wlen)).astype(np.int32)
    words[np.arange(max_wlen)[None, :] >= wlen[:, None]] = 0

    n_succ = np.where(rng.random(n_words) < det_frac, 1,
                      2 + np.minimum(rng.zipf(1.6, n_words), branch_max - 2))
    n_succ = n_succ.astype(np.int32)
    # popularity-skewed successor draws: id ~ floor(n_words * u^2)
    succ = np.minimum((n_words * rng.random((n_words, branch_max)) ** 2),
                      n_words - 1).astype(np.int32)
    w = 1.0 / (1.0 + np.arange(branch_max, dtype=np.float32)) ** zipf_exp
    w = np.broadcast_to(w, (n_words, branch_max)).copy()
    w *= rng.uniform(0.5, 1.5, (n_words, branch_max)).astype(np.float32)
    w[np.arange(branch_max)[None, :] >= n_succ[:, None]] = 0.0
    w /= w.sum(axis=1, keepdims=True)
    slogp = np.where(w > 0, np.log(np.maximum(w, 1e-30)), -np.inf)
    as_long = lambda a: torch.from_numpy(a.astype(np.int64)).to(dev)
    return MixedLanguage(words=as_long(words), wlen=as_long(wlen),
                         succ=as_long(succ),
                         slogp=torch.from_numpy(
                             slogp.astype(np.float32)).to(dev))


def sample_tokens(generator: Optional[torch.Generator], lang: MixedLanguage,
                  batch: int, seq: int) -> torch.Tensor:
    """[batch, seq] int64 token stream from the word automaton: the start
    words, then every step's successor draws (Gumbel-max over the
    successor log-probs, one [seq, batch, branch_max] draw), both from
    `generator` on the language's device."""
    dev = lang.words.device
    n_words = lang.words.shape[0]
    wid = torch.randint(0, n_words, (batch,), generator=generator,
                        device=dev)
    pos = torch.zeros((batch,), dtype=torch.int64, device=dev)
    g = gumbel((seq, batch, lang.slogp.shape[1]), generator, dev)
    toks = []
    for t in range(seq):
        toks.append(lang.words[wid, pos])
        nxt = pos + 1
        boundary = nxt >= lang.wlen[wid]
        pick = torch.argmax(lang.slogp[wid] + g[t], dim=-1)
        wid = torch.where(boundary, lang.succ[wid, pick], wid)
        pos = torch.where(boundary, 0, nxt)
    return torch.stack(toks, dim=1)


# ---------------------------------------------------------------------------
# training (target CE / draft distillation)
# ---------------------------------------------------------------------------

def param_leaves(params: ModelParams) -> List[torch.Tensor]:
    """Every trainable tensor of a dense ModelParams, in a fixed order:
    the embedding, the layer stacks (by name), the final norm, the head."""
    out = [params.embed] + [params.layers[k] for k in sorted(params.layers)]
    out.append(params.final_norm)
    if params.lm_head is not None:
        out.append(params.lm_head)
    return out


def lr_lambda(steps: int) -> Callable[[int], float]:
    """`optax.warmup_cosine_decay_schedule(0, 1, w, steps)` with w =
    max(10, steps // 20): linear from 0 over w steps, then a cosine to 0
    over the remaining steps - w (clamped at its end)."""
    warm = max(10, steps // 20)
    decay = steps - warm

    def f(count: int) -> float:
        if count < warm:
            return count / warm
        c = min(count - warm, decay)
        return 0.5 * (1.0 + math.cos(math.pi * c / decay))
    return f


def make_optimizer(leaves: List[torch.Tensor], lr: float, steps: int):
    """optax.adamw(warmup_cosine_decay(0, lr, ...), weight_decay=0.01) as
    (torch.optim.AdamW, LambdaLR); step the scheduler after each step."""
    opt = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda(steps))


def ce_loss(cfg: ModelConfig, params: ModelParams,
            ids: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood of `ids` [B, T]."""
    B, T = ids.shape
    cache = init_cache(cfg, B, T, ids.device)
    logits, _ = transformer.forward(cfg, params, ids, cache)
    lp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    return -torch.gather(lp, -1, ids[:, 1:, None]).mean()


def soft_ce_loss(cfg_d: ModelConfig, params_d: ModelParams,
                 target_probs: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """Mean soft cross-entropy of the draft's next-token law against the
    target's probabilities [B, T, V]."""
    B, T = ids.shape
    logits, _ = transformer.forward(cfg_d, params_d, ids,
                                    init_cache(cfg_d, B, T, ids.device))
    lp = F.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(target_probs * lp, dim=-1))


def _fit(leaves, loss_of: Callable[[int], torch.Tensor], steps: int,
         lr: float, losses: Optional[list]) -> float:
    """The training loop: AdamW under the schedule, one loss a step.
    Returns the last step's loss; `losses`, if given, receives every
    step's loss as a float (read once, at the end)."""
    for t in leaves:
        t.requires_grad_(True)
    opt, sched = make_optimizer(leaves, lr, steps)
    hist = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_of(i)
        loss.backward()
        opt.step()
        sched.step()
        hist.append(loss.detach())
    for t in leaves:
        t.requires_grad_(False)
    vals = torch.stack(hist).tolist() if hist else [0.0]
    if losses is not None:
        losses.extend(vals)
    return vals[-1]


def train_lm(cfg: ModelConfig, seed: int, lang: MixedLanguage,
             steps: int = 1200, batch: int = 64, seq: int = 96,
             lr: float = 3e-3, device=None, losses: Optional[list] = None):
    """Train a target oracle by next-token CE on the language's device (the
    card unless given). Returns (params, final CE)."""
    dev = resolve_device(device)
    params = init_params(cfg, seed, device=dev)
    gen = fold_generator(seed, 7, device=dev)
    loss = _fit(param_leaves(params),
                lambda i: ce_loss(cfg, params,
                                  sample_tokens(gen, lang, batch, seq)),
                steps, lr, losses)
    return params, loss


def distill_lm(cfg_d: ModelConfig, cfg_t: ModelConfig, params_t, seed: int,
               lang: MixedLanguage, steps: int = 1200, batch: int = 64,
               seq: int = 96, lr: float = 3e-3, device=None,
               losses: Optional[list] = None):
    """Distill a (smaller) draft against the frozen target's distribution.
    Returns (params_d, final soft-CE)."""
    dev = resolve_device(device)
    params_d = init_params(cfg_d, seed, device=dev)
    gen = fold_generator(seed, 11, device=dev)

    def loss_of(i):
        ids = sample_tokens(gen, lang, batch, seq)
        with torch.no_grad():
            tl, _ = transformer.forward(cfg_t, params_t, ids,
                                        init_cache(cfg_t, batch, seq, dev))
            tp = torch.softmax(tl.float(), dim=-1)
        return soft_ce_loss(cfg_d, params_d, tp, ids)

    loss = _fit(param_leaves(params_d), loss_of, steps, lr, losses)
    return params_d, loss


def scale_draft_temperature(params_d: ModelParams, cfg_d: ModelConfig,
                            tau: float) -> ModelParams:
    """Draft logit temperature as a weight transform: logits/tau via
    lm_head scaling — the ONE calibration scalar. tau > 1 flattens the
    draft (more divergence, lower BE)."""
    s = 1.0 / float(tau)
    head = params_d.lm_head
    if isinstance(head, QuantizedLinear):
        return params_d._replace(lm_head=head._replace(scales=head.scales * s))
    if head is not None:
        return params_d._replace(lm_head=head * s)
    if cfg_d.tie_word_embeddings:
        raise ValueError("tied draft: untie (tie_word_embeddings=False) to "
                         "use temperature calibration")
    raise ValueError("draft has no lm_head")


# ---------------------------------------------------------------------------
# diagnostics: the p/q fingerprint
# ---------------------------------------------------------------------------

@torch.no_grad()
def _ratio_probe(cfg_d: ModelConfig, cfg_t: ModelConfig, params_d, params_t,
                 lang: MixedLanguage, generator, batch: int, seq: int):
    """On language samples x~corpus with continuation token y~q(.|x):
    per-position (log p(y) - log q(y), accept=min(1, p/q), target entropy).
    """
    dev = lang.words.device
    ids = sample_tokens(generator, lang, batch, seq)
    ql, _ = transformer.forward(cfg_d, params_d, ids,
                                init_cache(cfg_d, batch, seq, dev))
    pl, _ = transformer.forward(cfg_t, params_t, ids,
                                init_cache(cfg_t, batch, seq, dev))
    qlp = F.log_softmax(ql.float(), dim=-1)[:, :-1]
    plp = F.log_softmax(pl.float(), dim=-1)[:, :-1]
    y = torch.argmax(qlp + gumbel(qlp.shape, generator, dev), dim=-1)  # y~q
    lq = torch.gather(qlp, -1, y[..., None])[..., 0]
    lp = torch.gather(plp, -1, y[..., None])[..., 0]
    ent = -torch.sum(torch.exp(plp) * plp, dim=-1)
    acc = torch.clamp(torch.exp(lp - lq), max=1.0)
    return lp - lq, acc, ent


def ratio_stats(cfg_d: ModelConfig, cfg_t: ModelConfig, params_d, params_t,
                lang: MixedLanguage, generator, gamma: int = 10,
                batch: int = 64, seq: int = 96) -> dict:
    """Summary of the divergence fingerprint + the implied tokenwise BE
    (iid-alpha model: BE = (1 - a^(g+1)) / (1 - a)) for quick calibration
    without running the engine."""
    lr, acc, ent = _ratio_probe(cfg_d, cfg_t, params_d, params_t, lang,
                                generator, batch, seq)
    lr, acc, ent = (v.cpu().numpy().ravel() for v in (lr, acc, ent))
    a = float(acc.mean())
    be = (1 - a ** (gamma + 1)) / (1 - a) if a < 1 else gamma + 1
    hist, _ = np.histogram(np.clip(lr, -8, 2), bins=10, range=(-8, 2))
    return {
        "alpha": round(a, 4),
        "implied_tokenwise_be": round(be, 3),
        "logratio_mean": round(float(lr.mean()), 3),
        "logratio_p05": round(float(np.percentile(lr, 5)), 3),
        "frac_hard_disagree": round(float((lr < -1.0).mean()), 4),
        "target_entropy_mean": round(float(ent.mean()), 3),
        "target_entropy_frac_low": round(float((ent < 0.1).mean()), 3),
        "logratio_hist_-8_2": hist.tolist(),
    }
