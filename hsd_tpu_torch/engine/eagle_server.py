"""Continuous batching for the EAGLE engine (port of
`hsd_tpu/engine/eagle_server.py`): a pool of slots where each pool block
runs one eagenerate block for every slot, while the host scheduler shared
with the speculative server (`server.SlotScheduler`) admits queued prompts
as requests finish.

Every pool block is ONE slot-batched target tree forward
(`eagle_engine.make_eagle_pool`), so each quantized weight streams once a
block for all slots. (The JAX package also keeps a per-slot vmapped pool,
`batched=False`, to A/B its Pallas grid; that comparison means nothing
for the CUDA kernels, and nothing here needs it.)

With `steps_per_dispatch` M > 1 a step is the JAX macro step, as in
`server.SlotEngine`: up to admit_batch queued requests are prefilled into a
refill stock in the pool's wide layout (their cache rows zero-padded by the
N + 1 staging tail, the slot axis second, as the JAX `prep_staged` does),
a slot whose request finishes inside the macro takes the next entry at once
under a device mask, and the host replays the refill chain after it.
Every request draws from the engine's one generator (seeded by `seed`):
prefills when they are admitted or staged, blocks in order, so a seeded run
repeats.

The single-slot math is shared with `make_eagle_generate`, so greedy EAGLE
equals the target's greedy AR stream per request, whatever the schedule.
"""
from __future__ import annotations

import inspect

import torch

from ..config import EngineConfig, ModelConfig
from ..models.eagle import EagleConfig
from .eagle_engine import make_eagle_block, make_eagle_pool
from .kvcache import KVCache, put_masked
from .server import Request, SlotScheduler


class EagleSlotEngine(SlotScheduler):
    """`server.SlotScheduler` around the EAGLE pool block; mode in
    {'greedy', 'typical', 'hsd', 'hsd_ref'}.

    Every pool block runs all `n_slots` rows (idle slots compute
    rows that nothing reads), so the target forward always stacks n_slots
    * (N+1) rows. An admitted or staged prompt is prefilled on its own, as
    the JAX package's vmapped prefill computes each slot.
    target_forward / target_cache_init: the target override and its cache
    (`eagle_engine.make_eagle_block`): a pool forward that takes lengths=
    and staging_at= (e.g. parallel/tp.py's `make_tp_eagle_pool_forward`
    with `tp_cache_init`).
    """

    def __init__(self, cfg_t: ModelConfig, ecfg: EagleConfig,
                 engine: EngineConfig, n_slots: int, bucket: int,
                 params_t=None, params_e=None, seed: int = 0,
                 admit_batch: int = 4, mode: str = "hsd",
                 target_forward=None, steps_per_dispatch: int = 1,
                 device=None, target_cache_init=None):
        super().__init__(n_slots, bucket, engine.max_new_tokens,
                         cfg_t.eos_token_id, admit_batch,
                         steps_per_dispatch, device)
        if target_forward is not None:
            # the pool calls target_forward(params, tokens, cache,
            # attn_bias, positions, lengths=, staging_at=): a single-request
            # forward would only fail inside the first block
            params = inspect.signature(target_forward).parameters
            names = set(params)
            varkw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                        for p in params.values())
            if not varkw and not {"lengths", "staging_at"} <= names:
                raise ValueError(
                    "the pool needs a slot-batched target_forward that "
                    "accepts lengths= and staging_at= (got parameters "
                    f"{sorted(names)}); use a pool-aware one (e.g. "
                    "parallel.tp.make_tp_eagle_pool_forward)")
        self.cfg_t, self.ecfg, self.engine = cfg_t, ecfg, engine
        self.N = ecfg.total_tokens
        self.S = bucket + self.max_new + self.N + 2
        self.params_t, self.params_e = params_t, params_e
        self.gen = torch.Generator(device=self.dev).manual_seed(seed)
        self._prefill1, _, _, _ = make_eagle_block(
            cfg_t, ecfg, engine, mode=mode, target_forward=target_forward,
            target_cache_init=target_cache_init)
        self._pool_block = make_eagle_pool(
            cfg_t, ecfg, engine, mode=mode, target_forward=target_forward,
            target_cache_init=target_cache_init)
        self.state = None            # built from the first prefill's shapes
        self._stock = None           # the same layout, admit_batch entries

    def _init_state(self, tc: KVCache, ek, fb, B: int):
        """Pool state of B slots shaped after one B=1 prefill: ONE batch-B
        cache whose sequence axis carries the N+1 staging slots past S,
        the head KV and the feature buffer."""
        dev, i64 = self.dev, torch.int64
        wide = (tc.k.shape[0], B, tc.k.shape[2] + self.N + 1) + tc.k.shape[3:]
        full = lambda v: torch.full((B,), v, dtype=i64, device=dev)
        return dict(
            tokens=torch.zeros((B, self.S), dtype=i64, device=dev),
            length=full(2), max_new=full(self.max_new),
            active=torch.zeros((B,), dtype=torch.bool, device=dev),
            acc_sum=full(0), blk_cnt=full(0),
            tcache=KVCache(k=torch.zeros(wide, dtype=tc.k.dtype, device=dev),
                           v=torch.zeros(wide, dtype=tc.v.dtype, device=dev),
                           length=0, start=full(0)),
            ekv=type(ek)(*(torch.zeros((B,) + t.shape[1:], dtype=t.dtype,
                                       device=dev) for t in ek)),
            feat_buf=torch.zeros((B,) + fb.shape[1:], dtype=fb.dtype,
                                 device=dev))

    def _prefill(self, req: Request, prompt: torch.Tensor):
        """Prefill `req` on its own (the engine's generator draws its root
        token); the pool state takes its shapes from the first one."""
        out = self._prefill1(self.params_t, self.params_e, prompt,
                             req.prompt_len, self.gen)
        if self.state is None:
            self.state = self._init_state(*out[2:], self.n_slots)
        return out

    def _write(self, st, s: int, req: Request, out):
        """A prefilled request into slot s of the pool state or entry s of
        the stock, its cache rows zero-padded by the staging tail."""
        tokens, length, tc, ek, fb = out
        st["tokens"][s] = tokens[0]
        st["length"][s] = length[0]
        st["max_new"][s] = min(req.max_new, self.max_new)
        st["active"][s] = True
        st["acc_sum"][s] = 0
        st["blk_cnt"][s] = 0
        pool = st["tcache"]
        S = tc.k.shape[2]
        pool.k[:, s, :S] = tc.k[:, 0]
        pool.v[:, s, :S] = tc.v[:, 0]
        pool.k[:, s, S:] = 0
        pool.v[:, s, S:] = 0
        pool.start[s] = tc.start[0]
        for dst, src in zip(st["ekv"], ek):
            dst[s] = src[0]
        st["feat_buf"][s] = fb[0]

    def _prefill_slot(self, s: int, req: Request, prompt: torch.Tensor):
        out = self._prefill(req, prompt)
        self._write(self.state, s, req, out)

    def _stage_entry(self, a: int, req: Request, prompt: torch.Tensor):
        out = self._prefill(req, prompt)
        if self._stock is None:
            self._stock = self._init_state(*out[2:], self.admit_batch)
        self._write(self._stock, a, req, out)

    def _merge(self, can, entry, plan):
        """Slot s takes stock entry entry[s] where can[s] (its tokens,
        length, budget, cache rows with their start, head KV and features;
        the counters zeroed, active), under the device mask."""
        dst, now = plan
        st, sk = self.state, self._stock
        for key in ("tokens", "length", "max_new", "feat_buf"):
            put_masked(st[key], dst, sk[key], now)
        for d, src in zip(st["ekv"], sk["ekv"]):
            put_masked(d, dst, src, now)
        tc, stc = st["tcache"], sk["tcache"]
        put_masked(tc.k, dst, stc.k, now, dim=1)
        put_masked(tc.v, dst, stc.v, now, dim=1)
        put_masked(tc.start, dst, stc.start, now)
        st.update(acc_sum=torch.where(can, 0, st["acc_sum"]),
                  blk_cnt=torch.where(can, 0, st["blk_cnt"]),
                  active=st["active"] | can)

    def _block(self) -> torch.Tensor:
        st = self.state
        (tokens2, length2, acc_len, _plen, hit_eos, tcache, ekv,
         feat_buf) = self._pool_block(self.params_t, self.params_e,
                                      st["tokens"], st["length"],
                                      st["tcache"], st["ekv"],
                                      st["feat_buf"], self.gen)
        # the cache, the head KV and the features of an idle slot hold rows
        # nothing reads (its frontier stays put) until admission or the
        # refill overwrites them
        st.update(tcache=tcache, ekv=ekv, feat_buf=feat_buf)
        active = st["active"]
        # every prompt is padded to the bucket, so it ends there
        budget = length2 - self.bucket >= st["max_new"]
        done = active & (hit_eos | budget)
        # tokens and counters advance on active slots only
        st.update(
            tokens=torch.where(active[:, None], tokens2, st["tokens"]),
            length=torch.where(active, length2, st["length"]),
            acc_sum=torch.where(active, st["acc_sum"] + acc_len,
                                st["acc_sum"]),
            blk_cnt=torch.where(active, st["blk_cnt"] + 1, st["blk_cnt"]),
            active=active & ~done)
        return done

    def _live(self) -> torch.Tensor:
        return self.state["active"]

    def _counters(self):
        st = self.state
        return st["acc_sum"], st["blk_cnt"], st["length"], st["tokens"]
