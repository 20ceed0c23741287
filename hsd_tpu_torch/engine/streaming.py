"""Streaming speculative generation (port of `hsd_tpu/engine/streaming.py`):
the blocks of make_generate, yielded one by one as host arrays of the
newly committed tokens, for interactive serving. With the same generator
the stream is make_generate's token stream cut into blocks.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from ..config import EngineConfig, ModelConfig
from ..models import transformer
from ..ops.sampling import processor
from .kvcache import init_cache
from .speculative import _commit_block, _draft_block


def make_stream_generate(cfg_draft: ModelConfig, cfg_target: ModelConfig,
                         engine: EngineConfig):
    """Returns `stream(params_d, params_t, prompt, prompt_len, generator)`,
    a Python generator of int64 numpy arrays: each block's committed tokens,
    until EOS (included) or the token budget."""
    v = engine.verifier
    if not v.parallel and v.num_drafts > 1:
        raise NotImplementedError("striped multidraft is not ported yet")
    gamma, K = v.gamma, v.num_drafts
    temp = processor(engine.temperature, engine.top_k, engine.top_p)
    max_new = engine.max_new_tokens
    eos = cfg_target.eos_token_id

    def stream(params_d, params_t, prompt: torch.Tensor, prompt_len: int,
               generator: Optional[torch.Generator] = None
               ) -> Iterator[np.ndarray]:
        dev = prompt.device
        P = prompt.shape[0]
        S = P + max_new + gamma + 2
        start = torch.full((K,), P - int(prompt_len), dtype=torch.int64,
                           device=dev)
        dcache = init_cache(cfg_draft, K, S, dev).replace(start=start.clone())
        tcache = init_cache(cfg_target, K, S, dev).replace(start=start.clone())
        pk = prompt[None, :].expand(K, P)
        _, dcache = transformer.forward(cfg_draft, params_d, pk[:, :-2],
                                        dcache, skip_head=True)
        _, tcache = transformer.forward(cfg_target, params_t, pk[:, :-1],
                                        tcache, skip_head=True)
        tokens = torch.zeros((S,), dtype=torch.int64, device=dev)
        tokens[:P] = prompt
        length, produced = P, 0
        while produced < max_new:
            last = tokens[length - 1]
            draft_toks, q, dcache = _draft_block(
                cfg_draft, params_d, dcache, tokens[length - 2], last, gamma,
                temp, generator)
            tgt_in = torch.cat([last.expand(K, 1), draft_toks], dim=1)
            tlogits, tcache = transformer.forward(cfg_target, params_t,
                                                  tgt_in, tcache)
            committed, dcache, tcache = _commit_block(
                v.method, draft_toks, q, temp(tlogits), tokens, length,
                dcache, tcache, generator, K)
            length += len(committed)
            chunk = committed[:max_new - produced]
            if eos in chunk:
                chunk = chunk[:chunk.index(eos) + 1]
            produced += len(chunk)
            yield np.asarray(chunk, dtype=np.int64)
            if eos in chunk:
                return

    return stream
