"""Stepwise and recursive HSD decoding (port of `hsd_tpu/engine/stepwise.py`;
see that module for how they follow the reference's non-clever modes).

* Stepwise: each block is the committed backward verifier (`hsd_ref`) over
  gamma drafted tokens, then inner steps that draft ONE token each and
  verify it with `forward_sampling_step` against the joint residual at the
  frontier, until the block has committed gamma tokens or a proposal is
  rejected.
* Recursive: each block runs rounds; round 0 drafts the full gamma budget,
  every later round re-drafts the REMAINING budget onto the accumulated
  trajectory (`_draft_tail`) and re-verifies it with `recursive_round`,
  whose residual rows replace the history's p-rows for the next round.

Both take K = 1 and run one request. The JAX package's while loops become
host loops: the draft length of a round and the inner loops' exit tests
are data-dependent, so each inner step or round syncs with the host once.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import EngineConfig, ModelConfig
from ..models import transformer
from ..ops.sampling import processor, sample
from ..verify.forward_sampling import forward_sampling_step
from ..verify.recursive import recursive_round
from .kvcache import init_cache, rollback
from .speculative import (GenerateResult, _commit_block, draft_rows,
                          final_length)


def _draft_tail(cfg: ModelConfig, params, cache, last2, last1, L: int,
                gamma: int, proc, generator: Optional[torch.Generator]):
    """Draft L tokens (1 <= L <= gamma, a host int) on a batch-1 cache that
    holds committed-2 positions, re-feeding the two newest committed tokens
    as `draft_rows` does. Returns (tokens [gamma], q [gamma, V], cache)
    with the first L rows valid and zeros after them."""
    tok01 = torch.stack([last2, last1])[None]
    logits0, cache = transformer.forward(cfg, params, tok01, cache)
    probs = proc(logits0[:, 1])                                  # [1, V]
    tok = sample(probs, generator)
    toks = torch.zeros((gamma,), dtype=torch.int64, device=probs.device)
    qs = torch.zeros((gamma, probs.shape[-1]), dtype=torch.float32,
                     device=probs.device)
    toks[0], qs[0] = tok[0], probs[0]
    for j in range(1, L):
        logits, cache = transformer.forward(cfg, params, tok[:, None], cache)
        probs = proc(logits[:, 0])
        tok = sample(probs, generator)
        toks[j], qs[j] = tok[0], probs[0]
    return toks, qs, cache


def _prefill(cfg_draft, cfg_target, params_draft, params_target, prompt,
             prompt_len: int, S: int):
    """Batch-1 caches holding committed-2 (draft) and committed-1 (target)
    prompt positions, and the token buffer [S] with the prompt."""
    dev = prompt.device
    P = prompt.shape[0]
    start = torch.full((1,), P - int(prompt_len), dtype=torch.int64,
                       device=dev)
    dcache = init_cache(cfg_draft, 1, S, dev).replace(start=start.clone())
    tcache = init_cache(cfg_target, 1, S, dev).replace(start=start.clone())
    _, dcache = transformer.forward(cfg_draft, params_draft,
                                    prompt[None, :-2], dcache, skip_head=True)
    _, tcache = transformer.forward(cfg_target, params_target,
                                    prompt[None, :-1], tcache, skip_head=True)
    tokens = torch.zeros((S,), dtype=torch.int64, device=dev)
    tokens[:P] = prompt
    return dcache, tcache, tokens


def _finish(tokens, host, length: int, P: int, max_new: int, eos: int,
            accepts, dlens, rounds) -> GenerateResult:
    """The final length (speculative.final_length) and the per-block
    telemetry packed into [max_new] arrays (-1 unused)."""
    length = final_length(host, length, P, max_new, eos)

    def arr(vals):
        a = torch.full((max_new,), -1, dtype=torch.int64)
        a[:len(vals)] = torch.tensor(vals, dtype=torch.int64)
        return a

    return GenerateResult(tokens=tokens, length=length, prompt_len=P,
                          blocks=len(accepts), accepts=arr(accepts),
                          draft_lens=arr(dlens), ncommit=length - P,
                          rounds=arr(rounds))


def make_stepwise_generate(cfg_draft: ModelConfig, cfg_target: ModelConfig,
                           engine: EngineConfig):
    """Stepwise-HSD generate (K = 1), with make_generate's signature
    `generate(params_draft, params_target, prompt, prompt_len, generator)
    -> GenerateResult`; `rounds` holds each block's inner steps."""
    gamma = engine.verifier.gamma
    temp = processor(engine.temperature, engine.top_k, engine.top_p)
    max_new = engine.max_new_tokens
    eos = cfg_target.eos_token_id

    def generate(params_draft, params_target, prompt: torch.Tensor,
                 prompt_len: int, generator: Optional[torch.Generator] = None
                 ) -> GenerateResult:
        P = prompt.shape[0]
        S = P + max_new + gamma + 2
        dcache, tcache, tokens = _prefill(cfg_draft, cfg_target, params_draft,
                                          params_target, prompt, prompt_len, S)
        V = cfg_target.vocab_size
        dev = prompt.device
        host = prompt.tolist() + [0] * (S - P)
        accepts, rounds = [], []
        length, done = P, False
        while (not done and length + gamma + 2 <= S
               and len(accepts) < max_new and length - P < max_new):
            # outer backward block: the committed reference's verifier
            last = tokens[length - 1]
            draft_toks, q, dcache = draft_rows(
                cfg_draft, params_draft, dcache, tokens[length - 2], last,
                gamma, 1, False, temp, generator)
            tgt_in = torch.cat([last.view(1, 1), draft_toks], dim=1)
            tlogits, tcache = transformer.forward(cfg_target, params_target,
                                                  tgt_in, tcache)
            committed, dcache, tcache = _commit_block(
                "hsd_ref", draft_toks, q, temp(tlogits), tokens, length,
                dcache, tcache, generator, 1)
            n_match, n_commit = len(committed) - 1, len(committed)
            host[length:length + n_commit] = committed
            length += n_commit

            # forward-sampling inner steps until the block's budget
            stop = eos in committed or n_match >= gamma
            commits, cand_len = n_commit, 0
            cand = torch.zeros((gamma,), dtype=torch.int64, device=dev)
            qbuf = torch.zeros((gamma, V), dtype=torch.float32, device=dev)
            pbuf = torch.zeros((gamma, V), dtype=torch.float32, device=dev)
            while not stop and commits < gamma:
                prop, qrow, dcache = draft_rows(
                    cfg_draft, params_draft, rollback(dcache, length - 2),
                    tokens[length - 2], tokens[length - 1], 1, 1, False,
                    temp, generator)
                tlog, tcache = transformer.forward(
                    cfg_target, params_target, tokens[length - 1].view(1, 1),
                    rollback(tcache, length - 1))
                cand[cand_len] = prop[0, 0]
                qbuf[cand_len] = qrow[0, 0]
                pbuf[cand_len] = temp(tlog[0, 0])
                toks2, _ = forward_sampling_step(
                    cand, qbuf, pbuf, cand_len + 1,
                    last_step=commits + 1 >= gamma, generator=generator)
                # the step's one host sync. Like the JAX engine, no bonus
                # token is committed after an accepted last proposal.
                t, x_new = torch.stack([toks2[0], prop[0, 0]]).tolist()
                tokens[length] = toks2[0]
                host[length] = t
                length += 1
                # the trajectory keeps the committed token
                cand[cand_len] = toks2[0]
                stop = t != x_new or t == eos
                cand_len += 1
                commits += 1
            dcache = rollback(dcache, length - 2)
            tcache = rollback(tcache, length - 1)
            done = eos in host[P:length]
            accepts.append(n_match)
            rounds.append(cand_len)
        return _finish(tokens, host, length, P, max_new, eos, accepts,
                       [gamma] * len(accepts), rounds)

    return generate


def make_recursive_generate(cfg_draft: ModelConfig, cfg_target: ModelConfig,
                            engine: EngineConfig):
    """Recursive-HSD generate (K = 1), with make_generate's signature.
    `accepts` holds each block's accepted drafted tokens, `draft_lens` the
    tokens it drafted over all its rounds (>= gamma), `rounds` its
    rounds."""
    gamma = engine.verifier.gamma
    temp = processor(engine.temperature, engine.top_k, engine.top_p)
    max_new = engine.max_new_tokens
    eos = cfg_target.eos_token_id

    def generate(params_draft, params_target, prompt: torch.Tensor,
                 prompt_len: int, generator: Optional[torch.Generator] = None
                 ) -> GenerateResult:
        P = prompt.shape[0]
        S = P + max_new + gamma + 2
        dcache, tcache, tokens = _prefill(cfg_draft, cfg_target, params_draft,
                                          params_target, prompt, prompt_len, S)
        V = cfg_target.vocab_size
        dev = prompt.device
        host = prompt.tolist() + [0] * (S - P)
        accepts, dlens, rounds = [], [], []
        length, done = P, False
        while (not done and length + gamma + 2 <= S
               and len(accepts) < max_new and length - P < max_new):
            hist, accepted, drafted, n_rounds, stop = 0, 0, 0, 0, False
            cand = torch.zeros((gamma,), dtype=torch.int64, device=dev)
            qbuf = torch.zeros((gamma, V), dtype=torch.float32, device=dev)
            pbuf = torch.zeros((gamma + 1, V), dtype=torch.float32,
                               device=dev)
            while not stop and hist < gamma:
                L = gamma - hist
                # re-draft the remaining budget onto the committed trajectory
                tail, tail_q, dcache = _draft_tail(
                    cfg_draft, params_draft, rollback(dcache, length - 2),
                    tokens[length - 2], tokens[length - 1], L, gamma, temp,
                    generator)
                # one target forward over [last] + the gamma tail slots
                # (past L they hold zeros: masked for the live rows, then
                # rolled back)
                tgt_in = torch.cat([tokens[length - 1:length], tail])[None]
                tlogits, tcache = transformer.forward(
                    cfg_target, params_target, tgt_in,
                    rollback(tcache, length - 1))
                cand[hist:] = tail[:L]
                qbuf[hist:] = tail_q[:L]
                pbuf[hist:] = temp(tlogits[0])[:L + 1]
                out, n_commit, full, resid = recursive_round(
                    cand, qbuf, pbuf, hist, gamma, generator=generator)
                # the round's one host sync
                info = torch.cat([n_commit.view(1), full.view(1).long(),
                                  out]).tolist()
                n_commit, full = info[0], bool(info[1])
                committed = info[2:2 + n_commit]
                tokens[length:length + n_commit] = out[:n_commit]
                host[length:length + n_commit] = committed
                length += n_commit
                if not full:
                    # record the resampled token in the trajectory
                    cand[min(hist + n_commit - 1, gamma - 1)] = \
                        out[n_commit - 1]
                # the recursion: the history's p-rows become this round's
                # residual rows
                hist += n_commit
                pbuf[:min(hist, gamma)] = resid[:min(hist, gamma)]
                dcache = rollback(dcache, length - 2)
                tcache = rollback(tcache, length - 1)
                stop = full or eos in committed
                accepted += n_commit - 1
                drafted += L
                n_rounds += 1
            done = eos in host[P:length]
            accepts.append(accepted)
            dlens.append(drafted)
            rounds.append(n_rounds)
        return _finish(tokens, host, length, P, max_new, eos, accepts, dlens,
                       rounds)

    return generate
