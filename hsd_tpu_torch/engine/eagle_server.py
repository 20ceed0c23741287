"""Continuous batching for the EAGLE engine (port of
`hsd_tpu/engine/eagle_server.py`): a pool of slots where each engine step
runs one eagenerate block for every slot through ONE slot-batched target
tree forward (`eagle_engine.make_eagle_pool`), while the host scheduler
shared with the speculative server (`server.SlotScheduler`) admits queued
prompts as requests finish.

The single-slot math is shared with `make_eagle_generate`, so greedy EAGLE
equals the target's greedy AR stream per request, whatever the schedule.
"""
from __future__ import annotations

import torch

from ..config import EngineConfig, ModelConfig
from ..models.eagle import EagleConfig
from .eagle_engine import make_eagle_block, make_eagle_pool
from .kvcache import KVCache
from .server import Request, SlotScheduler


class EagleSlotEngine(SlotScheduler):
    """`server.SlotScheduler` around the slot-batched EAGLE pool block;
    mode in {'greedy', 'typical', 'hsd', 'hsd_ref'}.

    Every pool step runs all `n_slots` rows (idle slots compute rows that
    nothing reads), so the target forward always stacks n_slots * (N+1)
    rows and each quantized weight streams once per step. An admitted
    prompt is prefilled on its own, as the JAX package's vmapped prefill
    computes each slot. At most `admit_batch` requests are admitted per
    step; `steps_per_dispatch` pool blocks run between admissions, ending
    early when no slot is active or when a slot frees while requests wait.
    Every request draws from the engine's one generator (seeded by
    `seed`). The JAX package's per-slot vmapped pool (`batched=False`) is
    an A/B artifact of the Pallas grid and is not ported.
    """

    def __init__(self, cfg_t: ModelConfig, ecfg: EagleConfig,
                 engine: EngineConfig, n_slots: int, bucket: int,
                 params_t=None, params_e=None, seed: int = 0,
                 admit_batch: int = 4, mode: str = "hsd",
                 target_forward=None, steps_per_dispatch: int = 1,
                 device=None):
        super().__init__(n_slots, bucket, engine.max_new_tokens,
                         cfg_t.eos_token_id, admit_batch,
                         steps_per_dispatch, device)
        self.cfg_t, self.ecfg, self.engine = cfg_t, ecfg, engine
        self.N = ecfg.total_tokens
        self.S = bucket + self.max_new + self.N + 2
        self.params_t, self.params_e = params_t, params_e
        self.gen = torch.Generator(device=self.dev).manual_seed(seed)
        self._prefill1, _, _, _ = make_eagle_block(
            cfg_t, ecfg, engine, mode=mode, target_forward=target_forward)
        self._pool_block = make_eagle_pool(
            cfg_t, ecfg, engine, mode=mode, target_forward=target_forward)
        self.state = None            # built from the first prefill's shapes

    def _init_state(self, tc: KVCache, ek, fb):
        """Pool state shaped after one B=1 prefill: ONE batch-n_slots cache
        whose sequence axis carries the N+1 staging slots past S."""
        B, dev = self.n_slots, self.dev
        i64 = torch.int64
        wide = (tc.k.shape[0], B, tc.k.shape[2] + self.N + 1) + tc.k.shape[3:]
        full = lambda v: torch.full((B,), v, dtype=i64, device=dev)
        return dict(
            tokens=torch.zeros((B, self.S), dtype=i64, device=dev),
            length=full(2),
            max_new=full(self.max_new),
            active=torch.zeros((B,), dtype=torch.bool, device=dev),
            acc_sum=full(0),
            blk_cnt=full(0),
            tcache=KVCache(k=torch.zeros(wide, dtype=tc.k.dtype, device=dev),
                           v=torch.zeros(wide, dtype=tc.v.dtype, device=dev),
                           length=0, start=full(0)),
            ekv=type(ek)(*(torch.zeros((B,) + t.shape[1:], dtype=t.dtype,
                                       device=dev) for t in ek)),
            feat_buf=torch.zeros((B,) + fb.shape[1:], dtype=fb.dtype,
                                 device=dev),
        )

    def _prefill_slot(self, s: int, req: Request, prompt: torch.Tensor):
        tokens, length, tc, ek, fb = self._prefill1(
            self.params_t, self.params_e, prompt, req.prompt_len, self.gen)
        if self.state is None:
            self.state = self._init_state(tc, ek, fb)
        st = self.state
        S = tc.k.shape[2]
        st["tokens"][s] = tokens[0]
        st["length"][s] = length[0]
        st["max_new"][s] = min(req.max_new, self.max_new)
        st["active"][s] = True
        st["acc_sum"][s] = 0
        st["blk_cnt"][s] = 0
        pool = st["tcache"]
        pool.k[:, s, :S] = tc.k[:, 0]
        pool.v[:, s, :S] = tc.v[:, 0]
        pool.k[:, s, S:] = 0
        pool.v[:, s, S:] = 0
        pool.start[s] = tc.start[0]
        for dst, src in zip(st["ekv"], ek):
            dst[s] = src[0]
        st["feat_buf"][s] = fb[0]

    def _block(self) -> torch.Tensor:
        st = self.state
        (tokens2, length2, acc_len, _plen, hit_eos, tcache, ekv,
         feat_buf) = self._pool_block(self.params_t, self.params_e,
                                      st["tokens"], st["length"],
                                      st["tcache"], st["ekv"],
                                      st["feat_buf"], self.gen)
        active = st["active"]
        # every prompt is padded to the bucket, so it ends there
        budget = length2 - self.bucket >= st["max_new"]
        done = active & (hit_eos | budget)
        # tokens and counters advance on active slots only; the cache, the
        # head KV and the features of an idle slot hold rows nothing reads
        # (its frontier stays put) until admission overwrites them
        st.update(
            tokens=torch.where(active[:, None], tokens2, st["tokens"]),
            length=torch.where(active, length2, st["length"]),
            acc_sum=torch.where(active, st["acc_sum"] + acc_len,
                                st["acc_sum"]),
            blk_cnt=torch.where(active, st["blk_cnt"] + 1, st["blk_cnt"]),
            active=active & ~done, tcache=tcache, ekv=ekv,
            feat_buf=feat_buf)
        return done

    def _counters(self):
        st = self.state
        return st["acc_sum"], st["blk_cnt"], st["length"], st["tokens"]
