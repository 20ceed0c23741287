"""Faults planted beneath the harness, which the check has to catch: each
`fault(engine, served, inst)` breaks the timed path of a built engine and
returns what puts it back. The CPU tests plant each for a whole run;
`control.py` reads each on the card at a cell's size, planted after the
window for the blocks that the check captures (the harvest's fault for the
whole run, since the check reads the window's harvests).

  state_unchanged  a block runs, then the pool's tokens, lengths, flags
                   and counters are put back as they were
  half_batch       the target verify's second half of the rows left out,
                   given the mean of the first half
  token_altered    the verifier's last token of a block altered where it
                   is produced
  harvest_altered  a finished request's first output token altered where
                   the server harvests it
"""
from __future__ import annotations

import torch


def state_unchanged(engine, served, inst):
    pool, inner = engine.pool, inst.block_fn

    def frozen(*a):
        keep = [t.clone() for t in (pool.tokens, pool.length, pool.live,
                                    pool.acc_sum, pool.blk_cnt)]
        out = inner(*a)
        (pool.tokens, pool.length, pool.live, pool.acc_sum,
         pool.blk_cnt) = keep
        return out
    inst.block_fn = frozen
    return lambda: setattr(inst, "block_fn", inner)


def half_batch(engine, served, inst):
    pool, fwd = engine.pool, engine.pool.tfwd

    def half(params, tokens, cache, lengths, skip_head=False):
        logits, cache = fwd(params, tokens, cache, lengths, skip_head)
        if logits is not None:
            n = logits.shape[0] // 2
            logits = torch.cat([logits[:n], logits[:n].mean(
                0, keepdim=True).expand(logits.shape[0] - n, -1, -1)])
        return logits, cache
    pool.tfwd = half
    return lambda: setattr(pool, "tfwd", fwd)


def token_altered(engine, served, inst):
    pool, verify = engine.pool, engine.pool._verify
    V = served.cfg_draft.vocab_size

    def altered(d, q, p, noise):
        res = verify(d, q, p, noise)
        toks = res.tokens.clone()
        at = res.n_matches[:, None]
        toks.scatter_(1, at, (toks.gather(1, at) + 1) % V)
        return res._replace(tokens=toks)
    pool._verify = altered
    return lambda: setattr(pool, "_verify", verify)


def harvest_altered(engine, served, inst):
    finish = engine._finish
    V = served.cfg_draft.vocab_size

    def altered(req, *result):
        req = finish(req, *result)
        if req.out_tokens:
            req.out_tokens = [(req.out_tokens[0] + 1) % V] + \
                req.out_tokens[1:]
        return req
    engine._finish = altered
    return lambda: delattr(engine, "_finish")


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch,
                                  token_altered, harvest_altered)}
