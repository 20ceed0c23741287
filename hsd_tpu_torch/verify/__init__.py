"""Acceptance rules: tokenwise / blockwise / HSD / greedy, and the trie
verifiers of EAGLE drafting."""
from .common import Telemetry, VerifyResult
from .tokenwise import verify_tokenwise
from .blockwise import verify_blockwise, verify_greedy
from .hsd import verify_hsd
from .dispatch import verify
from .trie import verify_trie_greedy, verify_trie_hsd, verify_trie_typical
from .forward_sampling import forward_sampling_step
from .recursive import recursive_round

__all__ = ["Telemetry", "VerifyResult", "verify", "forward_sampling_step",
           "recursive_round", "verify_tokenwise", "verify_blockwise",
           "verify_greedy", "verify_hsd", "verify_trie_greedy",
           "verify_trie_hsd", "verify_trie_typical"]
