"""Continuous batching: slot-based multi-request speculative serving (port of
`hsd_tpu/engine/server.py`).

A fixed pool of request slots decodes in lockstep: each pool step runs ONE
speculative block for every slot (`speculative.SlotPool.block`: the draft
over slots x R rows at each slot's frontier, one slot-batched target
forward, the verifier per slot, the commit and rollback as tensor ops),
while a host scheduler admits queued prompts into slots as requests finish.
Each slot owns R cache rows (K parallel drafts, or the striped layout's
1 + gamma * (K - 1) rows, as in make_generate). A slot that holds no
request, or whose request is done, computes rows that nothing reads.

Each request draws its noise from its own torch.Generator, in
make_generate's order, so a served request's stream is the one
make_generate gives on that generator, whatever the schedule.

The host side (`SlotScheduler`: the queue, admission, harvest and stats)
is shared with the EAGLE server (`eagle_server.EagleSlotEngine`).
Refill stays on the host: between pool blocks, up to `admit_batch` queued
requests are prefilled, each on its own (as the JAX package's vmapped
prefill computes each one), and copied into free slots. The JAX package's
on-device macro refill (`macro_step`, the staging buffers and their
reconciliation) is not ported: with `steps_per_dispatch` M > 1 the port
runs up to M pool blocks between admissions and ends them early when no
slot is live or when a slot frees while requests wait, as EagleSlotEngine
does.

Telemetry: per-slot accepted-token and block counters ride in the pool;
`stats()` reports aggregate block efficiency and throughput, and each
harvested Request carries its own accepts and blocks.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from ..config import EngineConfig, ModelConfig
from ..models.transformer import resolve_device
from .speculative import SlotPool


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]    # bucketed (left-padded)
    prompt_len: int
    max_new: int
    generator: Optional[torch.Generator] = None   # SlotEngine's noise
    out_tokens: Optional[List[int]] = None
    accepts: int = 0     # accepted drafted tokens (telemetry)
    blocks: int = 0      # speculative blocks consumed


class SlotScheduler:
    """The host side of a slot pool, shared by SlotEngine and
    EagleSlotEngine: a queue of bucketed requests, admission into free
    slots (each prefilled on its own), up to `steps_per_dispatch` pool
    blocks between admissions, harvest with the EOS and budget cut, and
    stats. Occupancy (`slot_rid`) is host state; a pool block's one sync
    reads its done flags.

    A subclass supplies `_prefill_slot(s, req, prompt)` (admit request
    `req`, its bucketed prompt a device tensor, into slot s), `_block()`
    (one pool block for every slot -> done [slots] bool on the device; a
    done slot stops being live) and `_counters()` (the pool's per-slot
    accepted-token and block counters, committed lengths and tokens).
    """

    def __init__(self, n_slots: int, bucket: int, max_new: int, eos: int,
                 admit_batch: int, steps_per_dispatch: int, device):
        self.n_slots, self.bucket, self.max_new = n_slots, bucket, max_new
        self.eos = eos
        self.dev = resolve_device(device)
        self.queue: deque[Request] = deque()
        self.running: Dict[int, Request] = {}
        self.slot_rid = [-1] * n_slots
        self.admit_batch = min(admit_batch, n_slots)
        self.steps_per_dispatch = max(1, steps_per_dispatch)
        self.total_committed = 0
        self.step_time = 0.0
        self.pool_blocks = 0      # pool steps run (each: every slot's rows)
        self._done_acc = 0
        self._done_blk = 0

    def submit(self, rid: int, prompt_ids: List[int], max_new: int = 0):
        """Queue a request, its prompt cut and left-padded to the bucket."""
        ids = list(prompt_ids)[-self.bucket:]
        padded = [0] * (self.bucket - len(ids)) + ids
        self.queue.append(Request(rid, padded, len(ids),
                                  max_new or self.max_new))

    def _admit(self):
        """Prefill up to admit_batch queued requests into free slots, each
        on its own. Occupancy is host state (slot_rid): no device read."""
        free = [s for s in range(self.n_slots) if self.slot_rid[s] == -1]
        admitted = 0
        while self.queue and free and admitted < self.admit_batch:
            req = self.queue.popleft()
            s = free.pop(0)
            self._prefill_slot(s, req, torch.tensor(
                req.prompt, dtype=torch.int64, device=self.dev))
            self.slot_rid[s] = req.rid
            self.running[req.rid] = req
            admitted += 1

    def _pool_step(self) -> List[bool]:
        """One pool block for every slot; returns the slots that finished
        (a host list of bools: the step's one sync)."""
        done = self._block()
        self.pool_blocks += 1
        return done.tolist()

    def _harvest(self, done) -> List[Request]:
        slots = [s for s in range(self.n_slots)
                 if done[s] and self.slot_rid[s] >= 0]
        if not slots:
            return []
        acc_sum, blk_cnt, length, tokens = self._counters()
        idx = torch.tensor(slots, device=self.dev)
        rows = torch.cat([acc_sum[idx, None], blk_cnt[idx, None],
                          length[idx, None], tokens[idx]], 1)
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
        return finished

    def step(self) -> List[Request]:
        """Admit queued requests, run up to steps_per_dispatch pool blocks
        (ending early when every slot is free, or when a slot frees while
        requests wait), harvest the finished requests."""
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
        """Block efficiency over every harvested request plus the occupied
        slots, committed-token throughput over the step wall time, and the
        slot-blocks and pool blocks run."""
        acc, blk = float(self._done_acc), float(self._done_blk)
        running = [s for s in range(self.n_slots) if self.slot_rid[s] >= 0]
        if running:
            acc_sum, blk_cnt, _, _ = self._counters()
            idx = torch.tensor(running, device=self.dev)
            acc += float(acc_sum[idx].sum())
            blk += float(blk_cnt[idx].sum())
        be = (acc + blk) / blk if blk else 0.0
        tput = (self.total_committed / self.step_time
                if self.step_time else 0.0)
        return {"block_efficiency": be, "tokens_per_s": tput,
                "blocks": blk, "committed": self.total_committed,
                "pool_blocks": self.pool_blocks}

    def run_all(self, max_steps: int = 10_000) -> List[Request]:
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.queue and not self.running:
                break
        return out


class SlotEngine(SlotScheduler):
    """Continuous-batching speculative serving: `SlotScheduler` around
    `SlotPool`.

    admit_batch: admissions a step at most (each prefilled on its own, as
    EagleSlotEngine admits); the JAX package fills every free slot each
    step, in scatters of admit_batch, which is the same at admit_batch =
    n_slots. steps_per_dispatch: pool blocks between admissions.
    target_forward / target_cache_ops: SlotPool's flattened-rows protocol,
    `(params, tokens [slots * R, T], cache, lengths, skip_head=False) ->
    (logits, cache)` and `(init, put, select)`; the default is the plain
    transformer with every product routed on one slot's rows. (The JAX
    package's shard_map tensor- and pipeline-parallel server forwards wait
    for the port's parallel slice.)
    """

    def __init__(self, cfg_d: ModelConfig, cfg_t: ModelConfig,
                 engine: EngineConfig, n_slots: int, bucket: int,
                 params_d=None, params_t=None, seed: int = 0,
                 admit_batch: int = 4, target_forward=None,
                 target_cache_ops=None, steps_per_dispatch: int = 1,
                 device=None):
        super().__init__(n_slots, bucket, engine.max_new_tokens,
                         cfg_t.eos_token_id, admit_batch,
                         steps_per_dispatch, device)
        self.cfg_d, self.cfg_t, self.engine = cfg_d, cfg_t, engine
        self.gamma = engine.verifier.gamma
        self.S = bucket + self.max_new + self.gamma + 2
        self.params_d, self.params_t = params_d, params_t
        self.seed = seed
        self.pool = SlotPool(cfg_d, cfg_t, engine, n_slots, self.S, self.dev,
                             target_forward, target_cache_ops)
        self.R, self.striped = self.pool.R, self.pool.striped

    def submit(self, rid: int, prompt_ids: List[int], max_new: int = 0,
               generator: Optional[torch.Generator] = None):
        """Queue a request. Its noise comes from `generator`, else from one
        seeded by the engine's seed and rid, so a seeded run repeats."""
        super().submit(rid, prompt_ids, max_new)
        if generator is None:
            generator = torch.Generator(device=self.dev).manual_seed(
                (self.seed << 32) + rid)
        self.queue[-1].generator = generator

    def _prefill_slot(self, s: int, req: Request, prompt: torch.Tensor):
        self.pool.prefill(s, self.params_d, self.params_t, prompt,
                          req.prompt_len, min(req.max_new, self.max_new))

    def _block(self) -> torch.Tensor:
        gens = [self.running[r].generator if r >= 0 else None
                for r in self.slot_rid]
        done, _ = self.pool.block(self.params_d, self.params_t, self.bucket,
                                  [r >= 0 for r in self.slot_rid], gens)
        return done

    def _counters(self):
        pool = self.pool
        return pool.acc_sum, pool.blk_cnt, pool.length, pool.tokens
