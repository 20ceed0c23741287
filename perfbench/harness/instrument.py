"""Spans around the program's layers, set from the benchmark at run time
(the program is not edited), and the capture that the check reads.

Spans (host clock; with tracing also `torch.profiler.record_function`
ranges, so the device trace can credit each kernel to the span whose host
launch encloses it):
  server.step          SlotEngine.step
  server.admit         SlotPool.prefill and SlotPool.stage (admission)
  pool.block           SlotPool.block
  model.target_verify  the configuration's target forward in a block
  model.target_prefill the same forward in an admission (lengths None)
  model.draft          the draft's forward steps of a block (draft_rows)
  linear.route_a       ops.linear.dequant_matmul (dequantize-then-dot)
Spans count only while `recording` is set. With tracing, an admission or a
block synchronizes the device before and after it, so its host span holds
its device work, and a block records every slot's committed length, start
and live flag (for the work the rooflines count).

Capture (after the window): for the chosen slots, a block's state before
it, the verifier's inputs and result, both trunks' verify logits, and the
slot's tokens and length after it.

Snapshots (in the window): after every block, a copy of the pool's tokens
and lengths on the device, which the check holds each harvested request's
output against.

The block that the spans and the capture wrap is `block_fn`; a planted
fault (`harness/faults.py`) may replace it, beneath both.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch

from hsd_tpu_torch.engine import speculative
from hsd_tpu_torch.ops import linear

SPANS = ("server.step", "server.admit", "pool.block", "model.target_verify",
         "model.target_prefill", "model.draft", "linear.route_a")


class Instrument:
    def __init__(self, traced: bool, device):
        self.traced = traced
        self.dev = torch.device(device)
        self.recording = False
        self.totals: Dict[str, List[float]] = {n: [0, 0.0] for n in SPANS}
        self.blocks: List[dict] = []       # traced: each block's slot state
        self.admissions: List[int] = []    # traced: each admission's length
        self.capture_slots: List[int] = []
        self.capture_left = 0
        self.records: List[dict] = []
        self.snapshots: Optional[list] = None
        self.block_fn = None
        self._cur: Optional[dict] = None
        self._restore = []

    # ---- spans
    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        if not self.recording:
            yield
            return
        if sync:
            self._sync()
        rf = (torch.profiler.record_function(name) if self.traced
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
            if sync:
                self._sync()
        tot = self.totals[name]
        tot[0] += 1
        tot[1] += time.perf_counter() - t0

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _wrap(self, fn, name, sync=False, before=None):
        def wrapped(*a, **kw):
            if before is not None and self.recording:
                before(*a, **kw)
            with self.span(name, sync and self.traced):
                return fn(*a, **kw)
        return wrapped

    # ---- wiring
    def wrap_target(self, fwd):
        def target(params, tokens, cache, lengths, skip_head=False):
            name = ("model.target_prefill" if lengths is None
                    else "model.target_verify")
            with self.span(name):
                return fwd(params, tokens, cache, lengths, skip_head=skip_head)
        return target

    def attach(self, engine, target):
        """Wrap the engine's entry points and the module-level ones its
        pool calls; `detach` puts the module-level ones back."""
        self.engine, self.target = engine, target
        pool = engine.pool
        engine.step = self._wrap(engine.step, "server.step")
        pool.prefill = self._wrap(pool.prefill, "server.admit", sync=True,
                                  before=self._admit_len(4))
        pool.stage = self._wrap(pool.stage, "server.admit", sync=True,
                                before=self._admit_len(5))
        self.block_fn = pool.block
        traced_block = self._wrap(lambda *a: self.block_fn(*a), "pool.block",
                                  sync=True, before=self._block_state)
        pool.block = lambda *a: self._captured(traced_block, *a)
        verify = pool._verify
        pool._verify = lambda *a: self._verified(verify, *a)
        for mod, name, span in ((speculative, "draft_rows", "model.draft"),
                                (linear, "dequant_matmul", "linear.route_a")):
            orig = getattr(mod, name)
            self._restore.append((mod, name, orig))
            setattr(mod, name, self._wrap(orig, span))

    def detach(self):
        for mod, name, orig in self._restore:
            setattr(mod, name, orig)
        self._restore = []
        if getattr(self, "target", None) is not None:
            self.target.probe = None

    def _admit_len(self, at: int):
        def before(*a, **kw):
            if self.traced:
                self.admissions.append(int(a[at]))
        return before

    def _block_state(self, *a, **kw):
        if not self.traced:
            return
        pool = self.engine.pool
        R = pool.R
        st = torch.stack([pool.length, pool.dcache.start[::R],
                          pool.live.long()]).tolist()
        self.blocks.append({"length": st[0], "start": st[1], "live": st[2]})

    # ---- capture
    def start_capture(self, slots: List[int], blocks: int):
        self.capture_slots, self.capture_left = list(slots), blocks
        self.records = []
        self.target.probe = self._probe

    def _snapshot(self):
        if self.snapshots is not None:
            pool = self.engine.pool
            self.snapshots.append((pool.tokens.clone(), pool.length.clone()))

    def _captured(self, block, *a):
        if self.capture_left <= 0:
            out = block(*a)
            self._snapshot()
            return out
        pool, S = self.engine.pool, self.capture_slots
        idx = torch.tensor(S, device=pool.length.device)
        pre = torch.stack([pool.length[idx], pool.live[idx].long(),
                           pool.dcache.start[idx * pool.R]]).tolist()
        tokens = pool.tokens[idx].tolist()
        self._cur = {}
        out = block(*a)
        self._snapshot()
        cur, self._cur = self._cur, None
        post = pool.length[idx].tolist()
        after = pool.tokens[idx].tolist()
        for i, s in enumerate(S):
            if not pre[1][i]:
                continue
            L0 = pre[0][i]
            self.records.append(dict(
                slot=s, length=L0, start=pre[2][i], tokens=tokens[i][:L0],
                post_length=post[i], post_tokens=after[i][L0:L0 + pool.gamma
                                                          + 1],
                **{k: v[i] for k, v in cur.items()}))
        self.capture_left -= 1
        if self.capture_left == 0:
            self.target.probe = None
        return out

    def _probe(self, big, small):
        if self._cur is None:
            return
        R = self.engine.pool.R
        rows = [s * R for s in self.capture_slots]     # row 0 of each slot
        self._cur["big"] = big[rows].float().clone()
        self._cur["small"] = small[rows].float().clone()

    def _verified(self, verify, d, q, p, noise):
        res = verify(d, q, p, noise)
        if self._cur is not None:
            idx = self.capture_slots
            self._cur.update(
                draft=d[idx, 0].clone(), q=q[idx, 0].float().clone(),
                p=p[idx, 0].float().clone(),
                u=noise["u"][idx, 0].clone(), u2=noise["u2"][idx, 0].clone(),
                gumbel=noise["gumbel"][idx].clone(),
                n_matches=res.n_matches[idx].clone(),
                out=res.tokens[idx].clone())
        return res
