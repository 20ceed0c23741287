"""Decode orchestration: KV cache, speculative and autoregressive loops."""
from .kvcache import KVCache, init_cache, rollback, select_draft_row
from .speculative import GenerateResult, make_autoregressive, make_generate

__all__ = ["KVCache", "init_cache", "rollback", "select_draft_row",
           "GenerateResult", "make_autoregressive", "make_generate"]
