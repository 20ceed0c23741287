"""Acceptance rules: tokenwise / blockwise / HSD / greedy."""
from .common import VerifyResult
from .tokenwise import verify_tokenwise
from .blockwise import verify_blockwise, verify_greedy
from .hsd import verify_hsd
from .dispatch import verify

__all__ = ["VerifyResult", "verify", "verify_tokenwise", "verify_blockwise",
           "verify_greedy", "verify_hsd"]
