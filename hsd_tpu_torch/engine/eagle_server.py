"""Continuous batching for the EAGLE engine (port of
`hsd_tpu/engine/eagle_server.py`): a pool of slots where each engine step
runs one eagenerate block for every slot through ONE slot-batched target
tree forward (`eagle_engine.make_eagle_pool`), while a host scheduler admits
queued prompts as requests finish.

The single-slot math is shared with `make_eagle_generate`, so greedy EAGLE
equals the target's greedy AR stream per request, whatever the schedule.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from ..config import EngineConfig, ModelConfig
from ..models.eagle import EagleConfig
from ..models.transformer import resolve_device
from .eagle_engine import make_eagle_block, make_eagle_pool
from .kvcache import KVCache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]    # bucketed (left-padded)
    prompt_len: int
    max_new: int
    out_tokens: Optional[List[int]] = None
    accepts: int = 0     # accepted drafted tokens (telemetry)
    blocks: int = 0


class EagleSlotEngine:
    """Host-side continuous-batching scheduler around the slot-batched EAGLE
    pool block; mode in {'greedy', 'typical', 'hsd', 'hsd_ref'}.

    Every pool step runs all `n_slots` rows (idle slots compute rows that
    nothing reads), so the target forward always stacks n_slots * (N+1)
    rows and each quantized weight streams once per step. An admitted
    prompt is prefilled on its own, as the JAX package's vmapped prefill
    computes each slot. At most `admit_batch` requests are admitted per
    step; `steps_per_dispatch` pool blocks run between admissions, ending
    early when no slot is active or when a slot frees while requests wait.
    The JAX package's per-slot vmapped pool (`batched=False`) is an A/B
    artifact of the Pallas grid and is not ported.
    """

    def __init__(self, cfg_t: ModelConfig, ecfg: EagleConfig,
                 engine: EngineConfig, n_slots: int, bucket: int,
                 params_t=None, params_e=None, seed: int = 0,
                 admit_batch: int = 4, mode: str = "hsd",
                 target_forward=None, steps_per_dispatch: int = 1,
                 device=None):
        self.cfg_t, self.ecfg, self.engine = cfg_t, ecfg, engine
        self.n_slots, self.bucket = n_slots, bucket
        self.max_new = engine.max_new_tokens
        self.N = ecfg.total_tokens
        self.S = bucket + self.max_new + self.N + 2
        self.params_t, self.params_e = params_t, params_e
        self.dev = resolve_device(device)
        self.gen = torch.Generator(device=self.dev).manual_seed(seed)
        self.queue: deque[Request] = deque()
        self.running: Dict[int, Request] = {}
        self.slot_rid = [-1] * n_slots
        self.admit_batch = min(admit_batch, n_slots)
        self.eos = cfg_t.eos_token_id
        self.steps_per_dispatch = max(1, steps_per_dispatch)
        self._prefill1, _, _, _ = make_eagle_block(
            cfg_t, ecfg, engine, mode=mode, target_forward=target_forward)
        self._pool_block = make_eagle_pool(
            cfg_t, ecfg, engine, mode=mode, target_forward=target_forward)
        self.state = None            # built from the first prefill's shapes
        self.total_committed = 0
        self.step_time = 0.0
        self._done_acc = 0
        self._done_blk = 0

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

    def submit(self, rid: int, prompt_ids: List[int], max_new: int = 0):
        ids = list(prompt_ids)[-self.bucket:]
        padded = [0] * (self.bucket - len(ids)) + ids
        self.queue.append(Request(rid, padded, len(ids),
                                  max_new or self.max_new))

    def _admit(self):
        free = [s for s in range(self.n_slots) if self.slot_rid[s] == -1]
        admitted = 0
        while self.queue and free and admitted < self.admit_batch:
            req = self.queue.popleft()
            s = free.pop(0)
            prompt = torch.tensor(req.prompt, dtype=torch.int64,
                                  device=self.dev)
            tokens, length, tc, ek, fb = self._prefill1(
                self.params_t, self.params_e, prompt, req.prompt_len,
                self.gen)
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
            self.slot_rid[s] = req.rid
            self.running[req.rid] = req
            admitted += 1

    def _pool_step(self) -> List[bool]:
        """One pool block for every slot; returns the slots that finished
        (a host list of bools: the step's one sync)."""
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
            tcache=tcache, ekv=ekv, feat_buf=feat_buf)
        return done.tolist()

    def _harvest(self, done) -> List[Request]:
        slots = [s for s in range(self.n_slots)
                 if done[s] and self.slot_rid[s] >= 0]
        if not slots:
            return []
        st = self.state
        idx = torch.tensor(slots, device=self.dev)
        rows = torch.cat([st["acc_sum"][idx, None], st["blk_cnt"][idx, None],
                          st["length"][idx, None], st["tokens"][idx]], 1)
        finished = []
        for s, row in zip(slots, rows.tolist()):
            req = self.running.pop(self.slot_rid[s])
            toks = row[3 + self.bucket:3 + row[2]]
            if self.eos in toks:
                toks = toks[:toks.index(self.eos) + 1]
            req.out_tokens = toks[:req.max_new]
            req.accepts, req.blocks = row[0], row[1]
            self._done_acc += req.accepts
            self._done_blk += req.blocks
            finished.append(req)
            self.slot_rid[s] = -1
        st["active"][idx] = False
        return finished

    def step(self) -> List[Request]:
        t0 = time.perf_counter()
        self._admit()
        out: List[Request] = []
        if any(r >= 0 for r in self.slot_rid):
            for _ in range(self.steps_per_dispatch):
                finished = self._harvest(self._pool_step())
                out.extend(finished)
                if all(r < 0 for r in self.slot_rid):
                    break
                if finished and self.queue:
                    break
        self.step_time += time.perf_counter() - t0
        self.total_committed += sum(len(r.out_tokens) for r in out)
        return out

    def stats(self) -> Dict[str, float]:
        acc, blk = float(self._done_acc), float(self._done_blk)
        if self.state is not None:
            running = [s for s in range(self.n_slots)
                       if self.slot_rid[s] >= 0]
            if running:
                idx = torch.tensor(running, device=self.dev)
                acc += float(self.state["acc_sum"][idx].sum())
                blk += float(self.state["blk_cnt"][idx].sum())
        be = (acc + blk) / blk if blk else 0.0
        tput = (self.total_committed / self.step_time
                if self.step_time else 0.0)
        return {"block_efficiency": be, "tokens_per_s": tput,
                "blocks": blk, "committed": self.total_committed}

    def run_all(self, max_steps: int = 10_000) -> List[Request]:
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.queue and not self.running:
                break
        return out
