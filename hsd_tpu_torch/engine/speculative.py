"""Speculative decode orchestration (port of `hsd_tpu/engine/speculative.py`).

Each block: draft gamma tokens for each of the R draft rows, one target
forward over [last] + draft for all rows, a verifier, commit, O(1) KV
rollback and the multidraft row select. The block loop runs in Python with
ONE host sync per block (the verifier's result); the draft loop and the
layer loop never wait for the device.

Multidraft row layouts (VerifierConfig.parallel): parallel, R = K
independent drafts; striped, R = 1 + gamma * (K - 1) rows, the primary
draft and then gamma groups of K - 1 branch rows, group j mirroring the
primary through position j - 1, sampling its own token at position j and
following its own path after (`draft_rows`).

Cache invariants between blocks: the target holds committed-1 positions
(the newest token is re-fed each block); the draft holds committed-2,
because after a fully accepted block the last draft token's KV was never
computed by the draft, so the first draft step re-feeds two tokens.

Many requests at once (`SlotPool`, `make_generate_batched`, and the
continuous-batching `server.SlotEngine`): slots decode in lockstep, each on
R cache rows of one stacked cache at its own frontier, one block for every
slot per step with one host sync. Each request draws its noise from its own
generator in `make_generate`'s order, so a pooled request's stream is the
one `make_generate` gives on that generator.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.func import vmap

from ..config import EngineConfig, ModelConfig, VerifierConfig
from ..models import transformer
from ..ops.sampling import gumbel_of, processor, sample
from ..verify import verify
from ..verify.dispatch import TELEMETRY_METHODS, verify_noise
from .kvcache import (EMPTY_LENGTH, KVCache, init_cache, live_length,
                      put_rows, rollback, select_draft_row, select_rows,
                      slot_frontiers, winning_rows)


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


def activation_steps(gamma: int, num_drafts: int, device) -> torch.Tensor:
    """[R] the draft step at which each striped row starts sampling its
    own tokens: 0 for the primary, j for group j."""
    return torch.cat([torch.zeros((1,), dtype=torch.int64, device=device),
                      torch.arange(gamma, device=device).repeat_interleave(
                          num_drafts - 1)])


def draft_rows(cfg: ModelConfig, params, cache: KVCache, last2, last1,
               gamma: int, num_drafts: int, striped: bool, proc,
               generator: Optional[torch.Generator],
               noise: Optional[Callable[[int], torch.Tensor]] = None,
               lengths: Optional[torch.Tensor] = None, slots: int = 1):
    """One block's drafts, gamma tokens for each of the cache's N rows, in
    the engine's row layout: `slots` requests of R = N // slots rows each.

    Parallel: every row samples its own draft. Striped (R = 1 + gamma *
    (K - 1)): every row samples at every step, and a row whose activation
    step (0 for the primary, j for group j) is later than the step takes
    its request's row 0 sample instead, so its tokens and KV stay bitwise
    row 0's with no copy.

    last2/last1: the two newest committed tokens, 0-d (one request) or [N]
    (one a row). noise: optional `j -> [N, V]` Gumbel draws of step j,
    else `sample` draws from `generator`. lengths: optional [N] per-row
    cache frontiers (the slot pool's ragged rows), else the cache's own
    length; slots routes every product on one request's rows.
    Returns (draft_tokens [N, gamma], q [N, gamma, V], cache advanced)."""
    N = cache.batch
    act = activation_steps(gamma, num_drafts, last1.device) if striped \
        else None

    def step(tokens, j, cache):
        at = None if lengths is None else lengths + (j + 1 if j else 0)
        logits, cache = transformer.forward(cfg, params, tokens, cache,
                                            lengths=at, slots=slots)
        probs = proc(logits[:, -1])
        tok = sample(probs, generator, None if noise is None else noise(j))
        if striped:
            tok = tok.view(slots, -1)
            tok = torch.where(act > j, tok[:, :1], tok).view(-1)
        return tok, probs, cache

    tok, probs, cache = step(
        torch.stack([last2.expand(N), last1.expand(N)], dim=1), 0, cache)
    toks, qs = [tok], [probs]
    for j in range(1, gamma):
        tok, probs, cache = step(tok[:, None], j, cache)
        toks.append(tok)
        qs.append(probs)
    return torch.stack(toks, dim=1), torch.stack(qs, dim=1), cache


def draft_layout(v: VerifierConfig) -> Tuple[bool, int]:
    """(striped, R): the verifier's row layout and the draft (and target)
    cache rows of one request."""
    striped = not v.parallel and v.num_drafts > 1
    return striped, (1 + v.gamma * (v.num_drafts - 1) if striped
                     else v.num_drafts)


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
                  t_rollback=rollback, t_select=select_draft_row, tel=None,
                  striped: bool = False):
    """Verify one block and commit it: write the committed tokens into
    `tokens` at `length`, roll the draft cache back to committed-2 and the
    target's to committed-1, and keep the winning draft row. `tel`, a
    [3, K, gamma] view, receives the block's telemetry. The block's one
    host sync. Returns (committed tokens as a host list, dcache, tcache)."""
    kw = dict(generator=generator, num_drafts=K, striped=striped)
    if tel is not None:
        res, tm = verify(method, draft_toks, q, p, return_telemetry=True,
                         **kw)
        tel.copy_(torch.stack(tm))
    else:
        res = verify(method, draft_toks, q, p, **kw)
    info = torch.cat([res.n_matches.view(1), res.draft_index.view(1),
                      res.tokens]).tolist()
    n_commit, row = info[0] + 1, info[1]
    tokens[length:length + n_commit] = res.tokens[:n_commit]
    new_length = length + n_commit
    dcache = rollback(dcache, new_length - 2)
    tcache = t_rollback(tcache, new_length - 1)
    if draft_toks.shape[0] > 1:
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
    gamma, K = v.gamma, v.num_drafts
    striped, R = draft_layout(v)
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
            draft_toks, q, dcache = draft_rows(
                cfg_draft, params_draft, dcache, tokens[length - 2], last,
                gamma, K, striped, temp, generator)
            tgt_in = torch.cat([last.expand(R, 1), draft_toks], dim=1)
            tlogits, tcache = tfwd(params_target, tgt_in, tcache)
            committed, dcache, tcache = _commit_block(
                method, draft_toks, q, temp(tlogits), tokens, length, dcache,
                tcache, generator, K, t_rollback, t_select,
                tel=None if tel is None else tel[:, len(accepts)],
                striped=striped)
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


class SlotPool:
    """Device state of `n_slots` requests decoding in lockstep, and the
    block that advances them all (the port of the JAX server's vmapped
    `pool_step`, `server.py:155-222`, and of `make_generate_batched`).

    Slot s owns cache rows [s * R, (s + 1) * R) of one stacked draft cache
    and one stacked target cache (R: the verifier's row layout, as in
    make_generate). Per slot: the committed tokens [S], the committed
    length (the draft rows hold length - 2 positions, the target rows
    length - 1: `kvcache.slot_frontiers`), a token budget, a live flag
    (admitted and not done) and the accepted-token and block counters. A
    slot that is not live computes rows that nothing reads, at an empty
    slot's frontier, and its tokens, length and counters stay as they were.

    target_forward: optional `(params, tokens [N, T], cache, lengths,
    skip_head=False) -> (logits [N, T, V], cache)` over flattened rows, N =
    slots x R: lengths [N] are the rows' frontiers (the ragged append), or
    None in an admission's prefill (the fresh cache's own length, 0), where
    skip_head=True (only the cache is needed). The default is
    transformer.forward with `slots = N // R`, so every product routes on
    one request's rows, as the JAX package's per-slot vmap routes them.
    target_cache_ops: optional `(init, put, select)` for a target whose
    state is not a single KVCache:
        init(batch, max_len, start, device) -> cache   (make_generate's)
        put(pool_cache, rows: slice, cache) -> pool_cache   (admission)
        select(cache, src [N]) -> cache   (row b takes row src[b]'s state)
    There is no rollback op: the frontiers, passed to every forward, are
    the rollback.
    """

    def __init__(self, cfg_draft: ModelConfig, cfg_target: ModelConfig,
                 engine: EngineConfig, n_slots: int, max_len: int, device,
                 target_forward=None, target_cache_ops=None):
        v = engine.verifier
        self.cfg_d = cfg_draft
        self.gamma, self.K, self.method = v.gamma, v.num_drafts, v.method
        self.striped, self.R = draft_layout(v)
        self.temp = processor(engine.temperature, engine.top_k, engine.top_p)
        self.eos = cfg_target.eos_token_id
        self.n_slots, self.S = n_slots, max_len
        self.dev = torch.device(device)
        R = self.R
        self.tfwd = target_forward or (
            lambda p, t, c, lengths, skip_head=False: transformer.forward(
                cfg_target, p, t, c, lengths=lengths, skip_head=skip_head,
                slots=t.shape[0] // R))
        if target_cache_ops is None:
            def t_init(batch, max_len, start, device):
                return init_cache(cfg_target, batch, max_len,
                                  device).replace(start=start)
            self.t_init, self.t_put, self.t_select = (t_init, put_rows,
                                                      select_rows)
        else:
            self.t_init, self.t_put, self.t_select = target_cache_ops
        dev, i64 = self.dev, torch.int64

        def full(value):
            return torch.full((n_slots,), value, dtype=i64, device=dev)

        self.tokens = torch.zeros((n_slots, max_len), dtype=i64, device=dev)
        self.length = full(EMPTY_LENGTH)
        self.max_new = full(engine.max_new_tokens)
        self.live = torch.zeros((n_slots,), dtype=torch.bool, device=dev)
        self.acc_sum = full(0)
        self.blk_cnt = full(0)
        N = n_slots * R
        self.dcache = init_cache(cfg_draft, N, max_len, dev)
        self.tcache = self.t_init(
            N, max_len, torch.zeros((N,), dtype=i64, device=dev), dev)
        nz = 0 if self.method != "greedy" else None
        self._verify = vmap(self._verify_one, in_dims=(0, 0, 0, nz))

    def _verify_one(self, d, q, p, noise):
        return verify(self.method, d, q, p, noise=noise, num_drafts=self.K,
                      striped=self.striped)

    def prefill(self, s: int, params_draft, params_target,
                prompt: torch.Tensor, prompt_len: int, max_new: int):
        """Admit a request into slot s: prefill its R rows on their own (as
        make_generate does, so the products see one request's rows) and
        copy them into the slot's rows. prompt: [P] int64, left-padded."""
        R, S, dev = self.R, self.S, self.dev
        P = prompt.shape[0]
        start = torch.full((R,), P - int(prompt_len), dtype=torch.int64,
                           device=dev)
        dc = init_cache(self.cfg_d, R, S, dev).replace(start=start.clone())
        tc = self.t_init(R, S, start.clone(), dev)
        pk = prompt[None, :].expand(R, P)
        _, dc = transformer.forward(self.cfg_d, params_draft, pk[:, :-2], dc,
                                    skip_head=True)
        _, tc = self.tfwd(params_target, pk[:, :-1], tc, None,
                          skip_head=True)
        rows = slice(s * R, (s + 1) * R)
        put_rows(self.dcache, rows, dc)
        self.tcache = self.t_put(self.tcache, rows, tc)
        self.tokens[s] = 0
        self.tokens[s, :P] = prompt
        self.length[s] = P
        self.max_new[s] = max_new
        self.live[s] = True
        self.acc_sum[s] = 0
        self.blk_cnt[s] = 0

    def _draft_noise(self, live_host, generators, V: int) -> torch.Tensor:
        """One draft step's Gumbel noise [slots * R, V]: each live slot's
        [R, V] from its own generator, the draw `sample` makes there (the
        uniforms, then `gumbel_of`, elementwise); noise of no generator
        (near 0) for the other slots."""
        u = torch.full((self.n_slots, self.R, V), 0.5, dtype=torch.float32,
                       device=self.dev)
        for s in range(self.n_slots):
            if live_host[s]:
                u[s] = torch.rand((self.R, V), generator=generators[s],
                                  device=self.dev, dtype=torch.float32)
        return gumbel_of(u).view(self.n_slots * self.R, V)

    def _verify_noise(self, live_host, generators, V: int):
        """Each slot's verifier noise bundle, stacked over the slots: a
        live slot's from its generator, zeros elsewhere."""
        if self.method == "greedy":
            return None
        own = [verify_noise(self.method, self.K, self.gamma, V, g, self.dev)
               if on else None for on, g in zip(live_host, generators)]
        ref = next(b for b in own if b is not None)
        return {k: torch.stack([ref[k].new_zeros(ref[k].shape)
                                if b is None else b[k] for b in own])
                for k in ref}

    def block(self, params_draft, params_target, prompt_end: int,
              live_host: Sequence[bool],
              generators: Sequence[Optional[torch.Generator]]):
        """One speculative block for every slot: the draft over slots x R
        rows at each row's frontier, ONE target forward over slots x R x
        (gamma + 1) rows, the verifier per slot under vmap on noise drawn
        beforehand, the commit as tensor ops (no per-slot sync), the
        per-slot rollback and row select. live_host: the host's mirror of
        the live flags (at least one); generators[s]: live slot s's
        generator (None: the global one).
        Returns (done [slots] bool, n_matches [slots]) on the device:
        done = live and the block hit EOS or the slot's budget (the prompt
        region ends at prompt_end); a done slot stops being live."""
        SL, R, gamma, S = self.n_slots, self.R, self.gamma, self.S
        dev, temp = self.dev, self.temp
        live, length = self.live, self.length
        at = live_length(length, live)
        last = self.tokens.gather(1, (at - 1)[:, None])[:, 0]
        last2 = self.tokens.gather(1, (at - 2)[:, None])[:, 0]
        dlen = slot_frontiers(at, 2, R)
        tlen = slot_frontiers(at, 1, R)

        draft, q, dc = draft_rows(
            self.cfg_d, params_draft, self.dcache, last2.repeat_interleave(R),
            last.repeat_interleave(R), gamma, self.K, self.striped, temp,
            None, noise=lambda j: self._draft_noise(
                live_host, generators, self.cfg_d.vocab_size),
            lengths=dlen, slots=SL)
        V = q.shape[-1]
        tgt_in = torch.cat([last.repeat_interleave(R)[:, None], draft], 1)
        tlogits, tc = self.tfwd(params_target, tgt_in, self.tcache, tlen)
        p = temp(tlogits)
        res = self._verify(draft.view(SL, R, gamma), q.view(SL, R, gamma, V),
                           p.view(SL, R, gamma + 1, V),
                           self._verify_noise(live_host, generators, V))
        n_commit = res.n_matches + 1
        posn = torch.arange(S, device=dev)[None, :]
        src = res.tokens.gather(
            1, torch.clamp(posn - length[:, None], 0, gamma))
        write = (live[:, None] & (posn >= length[:, None])
                 & (posn < (length + n_commit)[:, None]))
        self.tokens = torch.where(write, src, self.tokens)
        new_length = torch.where(live, length + n_commit, length)
        if R > 1:
            src_rows = winning_rows(res.draft_index, R)
            select_rows(dc, src_rows)
            tc = self.t_select(tc, src_rows)
        self.dcache, self.tcache = dc, tc
        hit_eos = (write & (self.tokens == self.eos)).any(1)
        done = live & (hit_eos | (new_length - prompt_end >= self.max_new))
        self.length = new_length
        self.acc_sum = self.acc_sum + torch.where(live, res.n_matches, 0)
        self.blk_cnt = self.blk_cnt + live.long()
        self.live = live & ~done
        return done, res.n_matches


def make_generate_batched(cfg_draft: ModelConfig, cfg_target: ModelConfig,
                          engine: EngineConfig):
    """Build `generate(params_draft, params_target, prompts [B, P],
    prompt_lens [B], generators) -> GenerateResult` with a leading B axis
    (the JAX package's vmap of make_generate over prompts and keys,
    `speculative.py:289-298`). The B requests decode in lockstep on a
    `SlotPool` of B slots (B x R flattened rows at per-row frontiers), each
    with its own done flag, budget and EOS cut, one host sync a block; each
    is prefilled on its own. generators: B torch.Generators (or Nones at
    temperature 0); row b is what make_generate gives request b with
    generator b. Result: tokens [B, S] on the device; length, blocks and
    ncommit int64 [B], accepts and draft_lens [B, max_new] on the host."""
    gamma = engine.verifier.gamma
    max_new = engine.max_new_tokens
    eos = cfg_target.eos_token_id

    def generate(params_draft, params_target, prompts: torch.Tensor,
                 prompt_lens, generators: Sequence[Optional[torch.Generator]]
                 ) -> GenerateResult:
        B, P = prompts.shape
        lens = [int(n) for n in (prompt_lens.tolist() if isinstance(
            prompt_lens, torch.Tensor) else prompt_lens)]
        if len(lens) != B or len(generators) != B:
            raise ValueError("one prompt length and one generator a prompt")
        pool = SlotPool(cfg_draft, cfg_target, engine, B,
                        P + max_new + gamma + 2, prompts.device)
        for b in range(B):
            pool.prefill(b, params_draft, params_target, prompts[b],
                         lens[b], max_new)
        live = [True] * B
        accepts: List[List[int]] = [[] for _ in range(B)]
        while any(live):
            done, n = pool.block(params_draft, params_target, P, live,
                                 generators)
            info = torch.cat([done.long(), n]).tolist()   # the block's sync
            for b in range(B):
                if live[b]:
                    accepts[b].append(info[B + b])
                    live[b] = not info[b]
        host = pool.tokens.tolist()
        raw = pool.length.tolist()
        length = [final_length(host[b], raw[b], P, max_new, eos)
                  for b in range(B)]
        acc = torch.full((B, max_new), -1, dtype=torch.int64)
        dlens = torch.full((B, max_new), -1, dtype=torch.int64)
        for b in range(B):
            acc[b, :len(accepts[b])] = torch.tensor(accepts[b],
                                                    dtype=torch.int64)
            dlens[b, :len(accepts[b])] = gamma
        i64 = torch.int64
        return GenerateResult(
            tokens=pool.tokens, length=torch.tensor(length, dtype=i64),
            prompt_len=P,
            blocks=torch.tensor([len(a) for a in accepts], dtype=i64),
            accepts=acc, draft_lens=dlens,
            ncommit=torch.tensor(length, dtype=i64) - P)

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
