"""A base model and an EAGLE head bundled in one class (port of
`hsd_tpu/modeling_eagle.py`, the counterpart of the reference's
`EAGLE-3H/eagle/modeling_eagle.py`).

A thin facade over the port's one model stack: the class holds the configs
and parameters, keeps the generate closures it built per (mode,
max_new_tokens, temperature), and exposes the tree-masked target forward.
Randomness comes from an explicit torch.Generator where the JAX class
takes a key (seed 0 when none is given, as the JAX class defaults to
PRNGKey(0)).

    eagle = Eagle.from_pretrained(base_dir, head_dir)          # checkpoints
    eagle = Eagle(cfg_t, params_t, ecfg, params_e)             # in memory
    res   = eagle.generate(prompt_ids, max_new_tokens=64)      # EAGLE decode
    toks, length = eagle.naive_generate(prompt_ids, 64)        # AR baseline
    logits, cache = eagle.forward_with_tree_mask(tokens, tree_mask)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .config import EngineConfig, ModelConfig
from .engine.eagle_engine import (EagleGenerateResult, autotune_total_tokens,
                                  make_eagle_generate)
from .engine.kvcache import KVCache, init_cache
from .engine.speculative import make_autoregressive
from .models import transformer
from .models.eagle import EagleConfig, EagleParams
from .models.loader import config_from_hf, load_eagle_hf, load_hf
from .models.transformer import resolve_device
from .verify.trie import (verify_trie_greedy, verify_trie_hsd,
                          verify_trie_typical)


def evaluate_posterior(candidates: torch.Tensor, p, mode: str = "hsd",
                       noise: Optional[dict] = None,
                       generator: Optional[torch.Generator] = None):
    """Trie verification of one problem by mode ('greedy', 'typical',
    'hsd'), dispatched to verify/trie.py. candidates: [R, L] root-to-leaf
    path rows (col 0 the committed root, -1 padding); p: the target rows
    [R, L, V] after each path position; noise: the verifier's uniforms
    for this problem (typical {"u": [L-1, R]}, hsd {"u": [R, L], "u2":
    [R]}), else drawn from `generator`. Returns (best_row, accept_len,
    sample_p [V])."""
    candidates, p = candidates[None], p[None]
    if noise is not None:
        noise = {k: v[None] for k, v in noise.items()}
    if mode == "greedy":
        out = verify_trie_greedy(candidates, p)
    elif mode == "typical":
        out = verify_trie_typical(candidates, p, noise=noise,
                                  generator=generator)
    elif mode == "hsd":
        out = verify_trie_hsd(candidates, p, noise=noise, generator=generator)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return tuple(o[0] for o in out)


class Eagle:
    """A base model and an EAGLE head (the reference's modeling_eagle.EAGLE)."""

    def __init__(self, cfg_target: ModelConfig, params_target,
                 ecfg: EagleConfig, params_eagle: EagleParams,
                 mode: str = "hsd"):
        self.cfg_target = cfg_target
        self.params_target = params_target
        self.ecfg = ecfg
        self.params_eagle = params_eagle
        self.mode = mode
        self.device = params_target.final_norm.device
        self._gen_cache = {}

    # -- construction ------------------------------------------------------
    @classmethod
    def from_pretrained(cls, base_path: str, head_path: str,
                        mode: str = "hsd", dtype=torch.bfloat16, device=None,
                        **head_overrides) -> "Eagle":
        """Load an HF base checkpoint directory and an EAGLE head checkpoint
        directory onto `device` (the card unless the caller passes another;
        the reference's `EAGLE.from_pretrained`). `dtype` is the head's and
        the base model's activation dtype (the JAX class leaves the base at
        its config's bf16). load_hf returns (cfg, params): both are kept,
        as the JAX class's `params_t = load_hf(...)` does not."""
        dev = resolve_device(device)
        cfg_t = dataclasses.replace(config_from_hf(base_path), dtype=dtype)
        cfg_t, params_t = load_hf(base_path, cfg_t, device=dev)
        ecfg = EagleConfig.from_json(
            f"{head_path}/config.json",
            target_hidden_size=cfg_t.hidden_size, dtype=dtype,
            **head_overrides)
        params_e = load_eagle_hf(head_path, params_t.embed, dtype=dtype,
                                 device=dev)
        return cls(cfg_t, params_t, ecfg, params_e, mode=mode)

    # -- tree-masked forward -----------------------------------------------
    def forward_with_tree_mask(self, tokens: torch.Tensor,
                               tree_mask: Optional[torch.Tensor] = None,
                               cache: Optional[KVCache] = None,
                               positions: Optional[torch.Tensor] = None,
                               max_len: int = 0
                               ) -> Tuple[torch.Tensor, KVCache]:
        """The target forward with the trie's ancestor mask over the new
        tokens. tokens: [B, T] (or [T]); tree_mask: [T, T] bool, True =
        attend (self and ancestors); cache: appended to when given, else a
        fresh cache of max_len slots (default: this call's T). Returns
        (logits [B, T, V] f32, cache)."""
        if tokens.dim() == 1:
            tokens = tokens[None, :]
        B, T = tokens.shape
        if cache is None:
            cache = init_cache(self.cfg_target, B, max_len or T,
                               tokens.device)
        bias = None
        if tree_mask is not None:
            bias = torch.where(tree_mask, 0.0, -1e30).float()
        return transformer.forward(self.cfg_target, self.params_target,
                                   tokens.long(), cache, attn_bias=bias,
                                   positions=positions)

    # -- generation ----------------------------------------------------------
    def _prompt(self, prompt_ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(prompt_ids), dtype=torch.int64,
                               device=self.device)

    def _generator(self, generator):
        return (generator if generator is not None
                else torch.Generator(device=self.device).manual_seed(0))

    def _engine(self, max_new_tokens: int, temperature: float, mode: str):
        k = ("eagle", mode, max_new_tokens, temperature)
        if k not in self._gen_cache:
            eng = EngineConfig(max_new_tokens=max_new_tokens,
                               temperature=temperature)
            self._gen_cache[k] = make_eagle_generate(
                self.cfg_target, self.ecfg, eng, mode=mode)
        return self._gen_cache[k]

    def generate(self, prompt_ids, max_new_tokens: int = 64,
                 temperature: float = 1.0, mode: Optional[str] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> EagleGenerateResult:
        """EAGLE speculative decoding of a 1-D prompt; the committed ids are
        tokens[:length]."""
        prompt = self._prompt(prompt_ids)
        gen = self._engine(max_new_tokens, temperature, mode or self.mode)
        return gen(self.params_target, self.params_eagle, prompt,
                   prompt.shape[0], self._generator(generator))

    def naive_generate(self, prompt_ids, max_new_tokens: int = 64,
                       temperature: float = 1.0,
                       generator: Optional[torch.Generator] = None):
        """Plain autoregressive decoding on the base model. Returns
        (tokens, length)."""
        k = ("ar", max_new_tokens, temperature)
        if k not in self._gen_cache:
            eng = EngineConfig(max_new_tokens=max_new_tokens,
                               temperature=temperature)
            self._gen_cache[k] = make_autoregressive(self.cfg_target, eng)
        prompt = self._prompt(prompt_ids)
        return self._gen_cache[k](self.params_target, prompt,
                                  prompt.shape[0], self._generator(generator))

    def tune_total_tokens(self, prompt_ids, candidates=(23, 47, 59),
                          max_new_tokens: int = 32, seed: int = 0):
        """Pick the trie size by timing short generates (the reference's
        ea_model.py:143-164); sets self.ecfg to the fastest and returns
        {candidate: committed tokens per second}."""
        prompt = self._prompt(prompt_ids)
        eng = EngineConfig(max_new_tokens=max_new_tokens)
        best, stats = autotune_total_tokens(
            self.cfg_target, self.ecfg, eng, self.params_target,
            self.params_eagle, prompt, prompt.shape[0], seed=seed,
            candidates=candidates, mode=self.mode)
        self.ecfg = best
        self._gen_cache.clear()
        return stats
