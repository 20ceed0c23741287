"""Speculative decode orchestration (port of `hsd_tpu/engine/speculative.py`).

Each block: draft gamma tokens for each of the K parallel draft rows, one
target forward over [last] + draft for all rows, a verifier, commit, O(1)
KV rollback and the multidraft row select. The block loop runs in Python
with ONE host sync per block (the verifier's result); the draft loop and
the layer loop never wait for the device.

Cache invariants between blocks: the target holds committed-1 positions
(the newest token is re-fed each block); the draft holds committed-2,
because after a fully accepted block the last draft token's KV was never
computed by the draft, so the first draft step re-feeds two tokens.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import EngineConfig, ModelConfig
from ..models import transformer
from ..ops.sampling import processor, sample
from ..verify import verify
from ..verify.dispatch import TELEMETRY_METHODS
from .kvcache import KVCache, init_cache, rollback, select_draft_row


class GenerateResult(NamedTuple):
    tokens: torch.Tensor      # [S_max] committed tokens incl. (padded) prompt
    length: int               # total committed length (incl. prompt pad)
    prompt_len: int           # bucket length of the prompt region
    blocks: int               # speculative blocks executed
    accepts: torch.Tensor     # [max_blocks] int64 n_matches per block (-1 unused)
    draft_lens: torch.Tensor  # [max_blocks] int64 drafted gamma per block
    ncommit: int              # committed new tokens
    # acceptance telemetry (the reference's return_probs channel), [max_blocks,
    # K, gamma] f32 with zero rows past `blocks`; None unless collected
    step_back_probs: Optional[torch.Tensor] = None
    p_i: Optional[torch.Tensor] = None
    q_i: Optional[torch.Tensor] = None
    # [max_blocks] int64 inner rounds per block (-1 unused) of the stepwise
    # and recursive engines; None for the single-pass engines
    rounds: Optional[torch.Tensor] = None


def _draft_block(cfg: ModelConfig, params, cache: KVCache, last2, last1,
                 gamma: int, proc, generator: Optional[torch.Generator]):
    """Draft gamma tokens for each of the K cache rows.

    last2/last1: 0-d device tensors, the two newest committed tokens.
    Returns (draft_tokens [K, gamma], q [K, gamma, V], cache advanced)."""
    K = cache.batch
    tok01 = torch.stack([last2.expand(K), last1.expand(K)], dim=1)
    logits0, cache = transformer.forward(cfg, params, tok01, cache)
    probs = proc(logits0[:, 1])
    tok = sample(probs, generator)
    toks, qs = [tok], [probs]
    for _ in range(gamma - 1):
        logits, cache = transformer.forward(cfg, params, tok[:, None], cache)
        probs = proc(logits[:, 0])
        tok = sample(probs, generator)
        toks.append(tok)
        qs.append(probs)
    return torch.stack(toks, dim=1), torch.stack(qs, dim=1), cache


def final_length(host, length: int, P: int, max_new: int, eos: int) -> int:
    """Clamp the committed length to the token budget (a full block can
    overshoot it), then cut after the first EOS in the generated region of
    the host token list."""
    length = min(length, P + max_new)
    for i in range(P, length):
        if host[i] == eos:
            return i + 1
    return length


def _commit_block(method: str, draft_toks, q, p, tokens: torch.Tensor,
                  length: int, dcache, tcache, generator, K: int,
                  t_rollback=rollback, t_select=select_draft_row, tel=None):
    """Verify one block and commit it: write the committed tokens into
    `tokens` at `length`, roll the draft cache back to committed-2 and the
    target's to committed-1, and keep the winning draft row. `tel`, a
    [3, K, gamma] view, receives the block's telemetry. The block's one
    host sync. Returns (committed tokens as a host list, dcache, tcache)."""
    if tel is not None:
        res, tm = verify(method, draft_toks, q, p, generator=generator,
                         num_drafts=K, return_telemetry=True)
        tel.copy_(torch.stack(tm))
    else:
        res = verify(method, draft_toks, q, p, generator=generator,
                     num_drafts=K)
    info = torch.cat([res.n_matches.view(1), res.draft_index.view(1),
                      res.tokens]).tolist()
    n_commit, row = info[0] + 1, info[1]
    tokens[length:length + n_commit] = res.tokens[:n_commit]
    new_length = length + n_commit
    dcache = rollback(dcache, new_length - 2)
    tcache = t_rollback(tcache, new_length - 1)
    if K > 1:
        dcache = select_draft_row(dcache, row)
        tcache = t_select(tcache, row)
    return info[2:2 + n_commit], dcache, tcache


def make_generate(cfg_draft: ModelConfig, cfg_target: ModelConfig,
                  engine: EngineConfig, collect_telemetry: bool = False,
                  target_forward=None, target_cache_ops=None):
    """Build `generate(params_draft, params_target, prompt, prompt_len,
    generator) -> GenerateResult`.

    prompt: [P_bucket] int64 on the device, LEFT-padded to the bucket.
    prompt_len: actual prompt token count (pad = P_bucket - prompt_len).
    generator: torch.Generator on the prompt's device (draft sampling and
    verifier noise).
    collect_telemetry: also record each block's step-back probabilities,
    p_i and q_i (tokenwise, hsd and hsd_ref) into the result.
    target_forward: optional `(params, tokens, cache, skip_head=False) ->
    (logits, cache)` override for the target (e.g. the coupled target in
    eval/synthetic.py). The prefills pass skip_head=True and discard the
    first item: they need only the cache, so no head runs there.
    target_cache_ops: optional `(init, rollback, select)` for a target whose
    state is not a single KVCache:
        init(batch, max_len, start, device) -> cache
        rollback(cache, new_length) -> cache
        select(cache, row) -> cache
    """
    v = engine.verifier
    if not v.parallel and v.num_drafts > 1:
        raise NotImplementedError("striped multidraft is not ported yet")
    gamma, K = v.gamma, v.num_drafts
    R = K
    method = v.method
    temp = processor(engine.temperature, engine.top_k, engine.top_p)
    max_new = engine.max_new_tokens
    max_blocks = max_new
    eos = cfg_target.eos_token_id
    telemetry = collect_telemetry and method in TELEMETRY_METHODS
    tfwd = target_forward or (lambda p, t, c, skip_head=False:
                              transformer.forward(cfg_target, p, t, c,
                                                  skip_head=skip_head))
    if target_cache_ops is None:
        def t_init(batch, max_len, start, device):
            return init_cache(cfg_target, batch, max_len,
                              device).replace(start=start)
        t_rollback, t_select = rollback, select_draft_row
    else:
        t_init, t_rollback, t_select = target_cache_ops

    def generate(params_draft, params_target, prompt: torch.Tensor,
                 prompt_len: int, generator: Optional[torch.Generator] = None
                 ) -> GenerateResult:
        dev = prompt.device
        P = prompt.shape[0]
        S = P + max_new + gamma + 2
        start = torch.full((R,), P - int(prompt_len), dtype=torch.int64,
                           device=dev)
        dcache = init_cache(cfg_draft, R, S, dev).replace(start=start.clone())
        tcache = t_init(R, S, start.clone(), dev)

        prompt_k = prompt[None, :].expand(R, P)
        _, dcache = transformer.forward(cfg_draft, params_draft,
                                        prompt_k[:, :-2], dcache,
                                        skip_head=True)
        _, tcache = tfwd(params_target, prompt_k[:, :-1], tcache,
                         skip_head=True)

        tokens = torch.zeros((S,), dtype=torch.int64, device=dev)
        tokens[:P] = prompt
        host = [0] * S
        host[:P] = prompt.tolist()
        accepts = []
        tel = (torch.zeros((3, max_blocks, K, gamma), dtype=torch.float32,
                           device=dev) if telemetry else None)
        length, done = P, False
        while (not done and length + gamma + 1 <= S
               and len(accepts) < max_blocks and length - P < max_new):
            last = tokens[length - 1]
            draft_toks, q, dcache = _draft_block(
                cfg_draft, params_draft, dcache, tokens[length - 2], last,
                gamma, temp, generator)
            tgt_in = torch.cat([last.expand(R, 1), draft_toks], dim=1)
            tlogits, tcache = tfwd(params_target, tgt_in, tcache)
            committed, dcache, tcache = _commit_block(
                method, draft_toks, q, temp(tlogits), tokens, length, dcache,
                tcache, generator, K, t_rollback, t_select,
                tel=None if tel is None else tel[:, len(accepts)])
            n_match = len(committed) - 1
            host[length:length + n_match + 1] = committed
            done = eos in committed
            length += n_match + 1
            accepts.append(n_match)

        length = final_length(host, length, P, max_new, eos)
        blocks = len(accepts)
        acc = torch.full((max_blocks,), -1, dtype=torch.int64)
        acc[:blocks] = torch.tensor(accepts, dtype=torch.int64)
        dlens = torch.full((max_blocks,), -1, dtype=torch.int64)
        dlens[:blocks] = gamma
        return GenerateResult(tokens=tokens, length=length, prompt_len=P,
                              blocks=blocks, accepts=acc, draft_lens=dlens,
                              ncommit=length - P,
                              **({} if tel is None else dict(
                                  step_back_probs=tel[0], p_i=tel[1],
                                  q_i=tel[2])))

    return generate


def make_autoregressive(cfg: ModelConfig, engine: EngineConfig,
                        model_forward=None, cache_init=None):
    """Plain AR sampling baseline: `generate(params, prompt, prompt_len,
    generator) -> (tokens [S], length)`. model_forward / cache_init follow
    make_generate's target_forward / target_cache_ops[0] protocol."""
    temp = processor(engine.temperature, engine.top_k, engine.top_p)
    max_new = engine.max_new_tokens
    eos = cfg.eos_token_id
    fwd = model_forward or (lambda p, t, c, skip_head=False:
                            transformer.forward(cfg, p, t, c,
                                                skip_head=skip_head))

    def cinit(batch, max_len, start, device):
        if cache_init is not None:
            return cache_init(batch, max_len, start, device)
        return init_cache(cfg, batch, max_len, device).replace(start=start)

    def generate(params, prompt: torch.Tensor, prompt_len: int,
                 generator: Optional[torch.Generator] = None):
        dev = prompt.device
        P = prompt.shape[0]
        S = P + max_new + 1
        start = torch.full((1,), P - int(prompt_len), dtype=torch.int64,
                           device=dev)
        cache = cinit(1, S, start, dev)
        _, cache = fwd(params, prompt[None, :-1], cache, skip_head=True)
        tokens = torch.zeros((S,), dtype=torch.int64, device=dev)
        tokens[:P] = prompt
        length = P
        while length - P < max_new:
            logits, cache = fwd(params, tokens[length - 1].view(1, 1), cache)
            nxt = sample(temp(logits[0, 0]), generator)
            tokens[length] = nxt
            length += 1
            if int(nxt) == eos:
                break
        return tokens, length

    return generate
