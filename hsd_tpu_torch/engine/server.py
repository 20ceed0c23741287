"""Continuous batching: slot-based multi-request speculative serving (port of
`hsd_tpu/engine/server.py`).

A fixed pool of request slots decodes in lockstep: each pool block runs ONE
speculative block for every slot (`speculative.SlotPool.block`: the draft
over slots x R rows at each slot's frontier, one slot-batched target
forward, the verifier per slot, the commit and rollback as tensor ops),
while a host scheduler admits queued prompts into slots as requests finish.
Each slot owns R cache rows (K parallel drafts, or the striped layout's
1 + gamma * (K - 1) rows, as in make_generate). A slot that holds no
request, or whose request is done, computes rows that nothing reads.

A step (`SlotScheduler.step`, in the JAX package's order, `server.py:
601-654`): staged requests left from the last step go into free slots,
queued requests fill the other free slots (each prefilled on its own, as
the JAX package's vmapped prefill computes each one), and then, with
`steps_per_dispatch` M > 1, up to admit_batch more queued requests are
prefilled into a refill stock on the device (`_stage`) and a macro step
runs up to M pool blocks (`_macro`, the JAX `macro_step`). Inside it a slot
whose request finishes has its final state snapshotted into that entry's
harvest row and takes the next staged request at once, under a device
mask (`SlotPool.merge`); the macro ends early only when no slot is live,
or when a slot frees with the stock spent while requests wait. So the
schedule, which requests finish in which step, is the JAX engine's. The
host reads one pair of flags a block (go on; a slot takes an entry) and,
after the macro, one packed vector: the harvest rows, from which it
replays the refill chain (`_reconcile`), and the finished slots. With M = 1
a step is one pool block and nothing is staged.

Each request draws its noise from its own torch.Generator, in
make_generate's order, so a served request's stream is the one
make_generate gives on that generator, whatever the schedule: every
request in a slot or in the stock owns a row of a device buffer that holds
its next M blocks' noise, topped up before each macro (a block's noise is
drawn once); a slot gathers its request's row at the blocks that request
has run, and a finished request's generator is set back to its state after
the blocks it ran.

The host side (`SlotScheduler`: the queue, admission, staging, the macro,
reconcile, harvest and stats) is shared with the EAGLE server
(`eagle_server.EagleSlotEngine`).

Telemetry: per-slot accepted-token and block counters ride in the pool;
`stats()` reports aggregate block efficiency and throughput, the requests
admitted by the refill and the host reads, and each harvested Request
carries its own accepts and blocks and its submission time. While a
profiler window is open (`utils.profiling`), a step records the spans
server.step, server.noise, server.host_read, server.refill and
server.harvest, each admission the admission counters and the request's
submission and prefill times, each harvest the request's harvest time.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from ..config import EngineConfig, ModelConfig
from ..models.transformer import resolve_device
from ..utils.profiling import admitted, harvested, span
from .kvcache import merge_plan
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
    submitted: float = 0.0   # host clock (perf_counter) at submit


class SlotScheduler:
    """The host side of a slot pool, shared by SlotEngine and
    EagleSlotEngine: a queue of bucketed requests, admission into free
    slots (each prefilled on its own), the refill stock, the macro step,
    the replay of its refill chain, harvest with the EOS and budget cut,
    and stats. Occupancy (`slot_rid`) is host state, brought up to date
    from the macro's one packed read.

    A subclass supplies `_prefill_slot(s, req, prompt)` (admit request
    `req`, its bucketed prompt a device tensor, into slot s),
    `_stage_entry(a, req, prompt)` (prefill it into entry a of the stock),
    `_merge(can, entry, plan)` (slot s takes entry entry[s] where can[s],
    under the device mask; plan: `kvcache.merge_plan`), `_block()` (one
    pool block for every slot -> done [slots] bool on the device; a done
    slot stops being live), `_live()` and `_counters()` (the pool's live
    flags; its per-slot accepted-token and block counters, committed
    lengths and tokens). `_begin_macro`, `_macro_tail` and `_end_macro`
    let it draw noise before a macro and read back what it needs after.
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
        self.steps = 0            # step() calls
        self.pool_blocks = 0      # pool blocks run (each: every slot's rows)
        self.host_reads = 0       # device-to-host reads made by step()
        self.refilled_total = 0   # requests admitted by the on-device refill
        self._staged_rids: List[int] = []
        self._staged_n = 0        # entries of the current stock
        self._staged_consumed = 0  # of them, already in slots
        self._done_acc = 0
        self._done_blk = 0

    def submit(self, rid: int, prompt_ids: List[int], max_new: int = 0):
        """Queue a request, its prompt cut and left-padded to the bucket."""
        ids = list(prompt_ids)[-self.bucket:]
        padded = [0] * (self.bucket - len(ids)) + ids
        self.queue.append(Request(rid, padded, len(ids),
                                  max_new or self.max_new,
                                  submitted=time.perf_counter()))

    def _prompt(self, req: Request) -> torch.Tensor:
        return torch.tensor(req.prompt, dtype=torch.int64, device=self.dev)

    def _free(self) -> List[int]:
        return [s for s in range(self.n_slots) if self.slot_rid[s] == -1]

    def _admit(self):
        """Fill every free slot from the queue. The JAX package does so in
        rounds of admit_batch, one batched prefill a round; here each
        request is prefilled on its own, so the rounds change nothing.
        Occupancy is host state (slot_rid): no device read."""
        for s in self._free():
            if not self.queue:
                break
            req = self.queue.popleft()
            admitted(req.rid, req.submitted, req.prompt, req.prompt_len)
            self._prefill_slot(s, req, self._prompt(req))
            self.slot_rid[s] = req.rid
            self.running[req.rid] = req

    def _stage(self):
        """With M > 1, prefill up to admit_batch queued requests into the
        refill stock. Entries are consumed in order, so the stock is
        refilled only once it is spent (a partial top-up would need device
        compaction)."""
        if (self.steps_per_dispatch <= 1 or not self.queue
                or self._staged_consumed < self._staged_n):
            return
        batch: List[Request] = []
        while self.queue and len(batch) < self.admit_batch:
            batch.append(self.queue.popleft())
        for a, req in enumerate(batch):
            self.running[req.rid] = req
            admitted(req.rid, req.submitted, req.prompt, req.prompt_len)
            self._stage_entry(a, req, self._prompt(req))
        self._staged_rids = [r.rid for r in batch]
        self._staged_n, self._staged_consumed = len(batch), 0

    def _admit_staged_to_free(self):
        """Staged entries left at a step's start go into free slots first
        (they were submitted before the queue's head), through the
        refill's merge, so no staged request waits for a slot that no live
        slot will free."""
        c0, n = self._staged_consumed, self._staged_n
        free = self._free()
        if c0 >= n or not free:
            return
        with span("server.refill"):
            can, entry = [False] * self.n_slots, [0] * self.n_slots
            for a, s in zip(range(c0, n), free):
                can[s], entry[s] = True, a
                self.slot_rid[s] = self._staged_rids[a]
                self._staged_consumed = a + 1
            can_t = torch.tensor(can, device=self.dev)
            entry_t = torch.tensor(entry, device=self.dev)
            self._merge(can_t, entry_t,
                        merge_plan(can_t, entry_t, self.admit_batch))

    def _macro(self) -> List[Request]:
        """Up to steps_per_dispatch pool blocks with the on-device refill
        (the JAX `macro_step`, `server.py:228-318`): after each block the
        freed slots take the stock's next entries in slot order, each
        finishing request snapshotted first into its entry's harvest row.
        The loop goes on while a slot is live, unless requests wait and a
        slot freed with the stock spent (the JAX cond); one read a block
        decides. Then the finished requests: `_finish_macro`."""
        M, SL, A, dev = (self.steps_per_dispatch, self.n_slots,
                         self.admit_batch, self.dev)
        c0, n_st = self._staged_consumed, self._staged_n
        stock = c0 < n_st
        stop_on_free = bool(self.queue)
        self._begin_macro()
        consumed = torch.full((), c0, dtype=torch.int64, device=dev)
        done_now = torch.zeros((SL,), dtype=torch.bool, device=dev)
        can = torch.zeros_like(done_now)
        harvest = None   # [A, 4 + S]: slot, length, accepts, blocks, tokens
        for i in range(M):
            done = self._block()
            self.pool_blocks += 1
            done_now = done_now | done
            after = consumed
            if stock:
                entry = consumed + torch.cumsum(done.long(), 0) - 1
                can = done & (entry < n_st)
                after = consumed + can.sum()
            last = i == M - 1
            if not last:
                go = (self._live() | can).any()
                if stop_on_free:
                    go = go & ~((done_now & ~can).any() & (after >= n_st))
                with span("server.host_read"):
                    go, take = torch.stack([go, can.any()]).tolist()
                self.host_reads += 1
            if stock and (last or take):
                with span("server.refill"):
                    plan = merge_plan(can, entry, A)
                    dst, now = plan
                    acc, blk, length, tokens = self._counters()
                    snap = torch.cat([dst[:, None], length[dst, None],
                                      acc[dst, None], blk[dst, None],
                                      tokens[dst]], 1)
                    if harvest is None:
                        harvest = torch.zeros_like(snap)
                    harvest = torch.where(now[:, None], snap, harvest)
                    self._merge(can, entry, plan)
                    done_now = done_now & ~can
                    consumed = after
            if not last and not go:
                break
        return self._finish_macro(consumed, done_now, harvest)

    def _finish_macro(self, consumed, done_now, harvest) -> List[Request]:
        """The macro's one packed read; replays the refill chain
        (`_reconcile`), then harvests the slots that finished."""
        SL = self.n_slots
        acc, blk, length, tokens = self._counters()
        S = tokens.shape[1]
        tail = self._macro_tail()
        parts = [consumed.view(1), done_now.long(), acc, blk, length,
                 tokens.reshape(-1), tail]
        if harvest is not None:
            parts.append(harvest.reshape(-1))
        with span("server.host_read"):
            vals = torch.cat(parts).tolist()
        self.host_reads += 1
        c1, o = vals[0], 1
        done, acc, blk, length = (vals[o + k * SL:o + (k + 1) * SL]
                                  for k in range(4))
        o += 4 * SL
        rows = [vals[o + s * S:o + (s + 1) * S] for s in range(SL)]
        o += SL * S
        self._end_macro(vals[o:o + tail.numel()])
        o += tail.numel()
        with span("server.harvest"):
            out = self._reconcile(c1, vals[o:], 4 + S)
            for s in range(SL):
                if done[s] and self.slot_rid[s] >= 0:
                    req = self.running.pop(self.slot_rid[s])
                    out.append(self._finish(req, length[s], acc[s], blk[s],
                                            rows[s]))
                    self.slot_rid[s] = -1
        return out

    def _reconcile(self, consumed: int, harvest: List[int],
                   width: int) -> List[Request]:
        """Replay the macro's refill chain: entry a displaced the request
        that slot harvest[a][0] held at that moment (entries in order,
        slots in order within a block), whose final state is harvest row
        a."""
        out = []
        for a in range(self._staged_consumed, consumed):
            s, length, acc, blk = harvest[a * width:a * width + 4]
            req = self.running.pop(self.slot_rid[s])
            out.append(self._finish(
                req, length, acc, blk,
                harvest[a * width + 4:(a + 1) * width]))
            self.slot_rid[s] = self._staged_rids[a]
            self.refilled_total += 1
        self._staged_consumed = max(consumed, self._staged_consumed)
        return out

    def _finish(self, req: Request, length: int, acc: int, blk: int,
                tokens: List[int]) -> Request:
        """A finished request's output: its generated tokens, cut after the
        first EOS and at its budget, and its telemetry."""
        toks = tokens[self.bucket:length]
        if self.eos in toks:
            toks = toks[:toks.index(self.eos) + 1]
        req.out_tokens = toks[:req.max_new]
        req.accepts, req.blocks = acc, blk
        self._done_acc += acc
        self._done_blk += blk
        harvested(req.rid, req.submitted)
        return req

    def _begin_macro(self):
        pass

    def _macro_tail(self) -> torch.Tensor:
        """Values the subclass reads back with the macro's packed read."""
        return torch.zeros((0,), dtype=torch.int64, device=self.dev)

    def _end_macro(self, tail: List[int]):
        pass

    def step(self) -> List[Request]:
        """Staged leftovers into free slots, queued requests into the rest,
        the stock staged, a macro of up to steps_per_dispatch pool blocks
        with the on-device refill, the finished requests harvested."""
        t0 = time.perf_counter()
        self.steps += 1
        with span("server.step"):
            self._admit_staged_to_free()
            self._admit()
            out: List[Request] = []
            if any(r >= 0 for r in self.slot_rid):
                self._stage()
                out = self._macro()
        self.step_time += time.perf_counter() - t0
        self.total_committed += sum(len(r.out_tokens) for r in out)
        return out

    def stats(self) -> Dict[str, float]:
        """Block efficiency over every harvested request plus the occupied
        slots, committed-token throughput over the step wall time, the
        slot-blocks and pool blocks run, the requests the refill admitted,
        the steps and the host reads."""
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
                "pool_blocks": self.pool_blocks,
                "refilled": self.refilled_total, "steps": self.steps,
                "host_reads": self.host_reads}

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

    admit_batch: the refill stock's entries (requests staged a macro).
    steps_per_dispatch: pool blocks a macro step (M; 1: one block a step,
    no staging). target_forward / target_cache_ops: SlotPool's
    flattened-rows protocol, `(params, tokens [slots * R, T], cache,
    lengths, skip_head=False) -> (logits, cache)` and `(init, put,
    select)`; the default is the plain transformer with every product
    routed on one slot's rows. The tensor- and pipeline-parallel server
    forwards (parallel/tp.py `make_tp_server_forward` with
    `tp_pool_cache_ops`, parallel/pp.py `make_pp_server_forward` with
    `pp_pool_cache_ops`) plug in here, the refill's merge included.
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
        self._stock = None       # SlotPool's Stock, made at the first staging
        # the noise drawn ahead (see _begin_macro): a row for every request
        # in a slot or in the stock, each a ring of M blocks
        rows = n_slots + self.admit_batch
        self._noise = None                       # (draft, bundle) [rows, M]
        self._free_rows = list(range(rows))
        self._row_of: Dict[int, int] = {}        # rid -> its row
        self._states: List[list] = [[] for _ in range(rows)]
        self._head_host = [0] * rows             # each ring's next block
        self._head = torch.zeros((rows,), dtype=torch.int64, device=self.dev)
        self._row_used = torch.zeros_like(self._head)   # blocks this macro
        self._slot_row = torch.zeros((n_slots,), dtype=torch.int64,
                                     device=self.dev)
        self._entry_row = torch.zeros((self.admit_batch,), dtype=torch.int64,
                                      device=self.dev)

    def submit(self, rid: int, prompt_ids: List[int], max_new: int = 0,
               generator: Optional[torch.Generator] = None):
        """Queue a request. Its noise comes from `generator`, else from one
        seeded by the engine's seed and rid, so a seeded run repeats."""
        super().submit(rid, prompt_ids, max_new)
        if generator is None:
            generator = torch.Generator(device=self.dev).manual_seed(
                (self.seed << 32) + rid)
        self.queue[-1].generator = generator

    def _take_row(self, req: Request) -> int:
        """A noise row for a request entering a slot or the stock: nothing
        drawn ahead yet, its generator's state as the base."""
        row = self._free_rows.pop()
        self._row_of[req.rid] = row
        self._states[row] = [req.generator.get_state()]
        return row

    def _prefill_slot(self, s: int, req: Request, prompt: torch.Tensor):
        self.pool.prefill(s, self.params_d, self.params_t, prompt,
                          req.prompt_len, min(req.max_new, self.max_new))
        self._slot_row[s] = self._take_row(req)

    def _stage_entry(self, a: int, req: Request, prompt: torch.Tensor):
        if self._stock is None:
            self._stock = self.pool.new_stock(self.admit_batch)
        self._stock = self.pool.stage(
            self._stock, a, self.params_d, self.params_t, prompt,
            req.prompt_len, min(req.max_new, self.max_new))
        self._entry_row[a] = self._take_row(req)

    def _merge(self, can, entry, plan):
        self.pool.merge(self._stock, can, entry, plan, self.bucket)
        e = torch.clamp(entry, 0, self.admit_batch - 1)
        self._slot_row = torch.where(can, self._entry_row[e], self._slot_row)

    def _begin_macro(self):
        """Top up the noise drawn ahead to M blocks for every request that
        can run in this macro (the slots' and the stock's): each block's
        from the request's generator in make_generate's order, into the
        next places of its row's ring, the generator's state recorded after
        each. A request drawn ahead keeps its noise across macros, so a
        block's noise is drawn once, and at most M - 1 blocks a request
        are drawn and never run. A slot gathers its row's ring at the
        blocks that row has run (`_row_used`). The draft's uniforms go
        straight into the ring; `SlotPool.block` takes their Gumbel
        transform for all slots at once."""
        with span("server.noise"):
            M, pool = self.steps_per_dispatch, self.pool
            if self._noise is None:
                self._noise = (torch.zeros(
                    (len(self._head_host), M, pool.gamma, pool.R,
                     self.cfg_d.vocab_size), dtype=torch.float32,
                    device=self.dev), None)
            draft, bundle = self._noise
            for rid, row in self._row_of.items():
                req = self.running[rid]
                for j in range(len(self._states[row]) - 1, M):
                    at = (self._head_host[row] + j) % M
                    _, nv = pool.block_noise(req.generator, out=draft[row, at])
                    self._states[row].append(req.generator.get_state())
                    if nv is None:
                        continue
                    if bundle is None:
                        bundle = {k: v.new_zeros((draft.shape[0], M) + v.shape)
                                  for k, v in nv.items()}
                        self._noise = (draft, bundle)
                    for k, v in nv.items():
                        bundle[k][row, at] = v
            self._row_used.zero_()

    def _block(self) -> torch.Tensor:
        draft, bundle = self._noise
        row = self._slot_row
        at = (self._head[row] + self._row_used[row]) % self.steps_per_dispatch
        noise = (draft[row, at], None if bundle is None else
                 {k: v[row, at] for k, v in bundle.items()})
        live = self.pool.live
        done, _ = self.pool.block(self.params_d, self.params_t, self.bucket,
                                  noise)
        self._row_used.index_add_(0, row, live.long())
        return done

    def _macro_tail(self) -> torch.Tensor:
        return self._row_used

    def _end_macro(self, tail: List[int]):
        """Each row's ring past the blocks its request ran; the state after
        them becomes the row's base."""
        M = self.steps_per_dispatch
        self._head = (self._head + self._row_used) % M
        for row, used in enumerate(tail):
            if used:
                self._head_host[row] = (self._head_host[row] + used) % M
                del self._states[row][:used]

    def _finish(self, req: Request, *result) -> Request:
        """Free a finished request's noise row, its generator set back to
        its state after the blocks it ran (make_generate's)."""
        row = self._row_of.pop(req.rid)
        req.generator.set_state(self._states[row][0])
        self._states[row] = []
        self._free_rows.append(row)
        return super()._finish(req, *result)

    def _live(self) -> torch.Tensor:
        return self.pool.live

    def _counters(self):
        pool = self.pool
        return pool.acc_sum, pool.blk_cnt, pool.length, pool.tokens
