"""Decode orchestration: KV cache, speculative and autoregressive loops.
EAGLE trie decoding is in `eagle_engine` and its slot server in
`eagle_server` (imported from there: models.eagle needs this package's
kvcache first)."""
from .kvcache import KVCache, init_cache, rollback, select_draft_row
from .speculative import GenerateResult, make_autoregressive, make_generate

__all__ = ["KVCache", "init_cache", "rollback", "select_draft_row",
           "GenerateResult", "make_autoregressive", "make_generate"]
