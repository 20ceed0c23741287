"""Decode orchestration: KV cache, speculative and autoregressive loops,
their batched, stepwise, recursive, streaming and prompt-lookup variants,
the continuous-batching slot server (`server.SlotEngine`) and UAD
(`uad`). EAGLE trie decoding is in `eagle_engine` and its slot server in
`eagle_server` (imported from there: models.eagle needs this package's
kvcache first)."""
from .kvcache import KVCache, init_cache, rollback, select_draft_row
from .speculative import (GenerateResult, make_autoregressive, make_generate,
                          make_generate_batched)
from .stepwise import make_recursive_generate, make_stepwise_generate
from .streaming import make_stream_generate
from .prompt_lookup import make_prompt_lookup_generate, propose_ngram
from .server import SlotEngine

__all__ = ["KVCache", "init_cache", "rollback", "select_draft_row",
           "GenerateResult", "make_autoregressive", "make_generate",
           "make_generate_batched", "SlotEngine",
           "make_stepwise_generate", "make_recursive_generate",
           "make_stream_generate", "make_prompt_lookup_generate",
           "propose_ngram"]
