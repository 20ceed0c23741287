"""Typed configuration for models, verification and the decode engine.

The PyTorch port's own copy of `hsd_tpu/config.py`: the same fields and
presets, with `dtype` a `torch.dtype`. The GPTQ path knob (`gptq_path`) and
the mesh config of the JAX package are left out: on a CUDA tensor every
quantized matmul runs its hand-written kernel, and the port runs on one
card. `gptq_mxu_bf16` stays, because it changes the numerics. Fields
that nothing here reads yet (MLP bias, MoE, max positions, the engine's
max_seq_len and seed) are left out too, so that setting one cannot quietly
give a different model; they come with the slices that implement them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Decoder-only transformer config covering the Qwen2/2.5 and Llama
    families (dense path)."""

    vocab_size: int = 151936
    hidden_size: int = 896
    intermediate_size: int = 4864
    num_layers: int = 24
    num_heads: int = 14
    num_kv_heads: int = 2
    head_dim: Optional[int] = None  # defaults to hidden_size // num_heads
    rope_theta: float = 1000000.0
    # Llama-3.1+ frequency-dependent RoPE scaling:
    # (factor, low_freq_factor, high_freq_factor, original_max_position)
    rope_scaling: Optional[Tuple[float, float, float, int]] = None
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    attention_bias: bool = True  # Qwen2 uses qkv bias; Llama does not
    dtype: torch.dtype = torch.bfloat16
    eos_token_id: int = 151645
    # bf16 operands with f32 accumulation in the quantized products at
    # 129-1024 rows (slot-batched serving, where they are bound by
    # operations): symmetric int8 weights there run the tensor-core kernel
    # K7. Off by default: the decode matvec keeps exact f32 operands.
    gptq_mxu_bf16: bool = False

    @property
    def head_dim_(self) -> int:
        return (self.head_dim if self.head_dim is not None
                else self.hidden_size // self.num_heads)

    @staticmethod
    def qwen2_05b(**kw) -> "ModelConfig":
        """Qwen2.5-0.5B-Instruct geometry (the draft model)."""
        return ModelConfig(**kw)

    @staticmethod
    def qwen2_14b(**kw) -> "ModelConfig":
        """Qwen2.5-14B geometry (the target model)."""
        d = dict(hidden_size=5120, intermediate_size=13824, num_layers=48,
                 num_heads=40, num_kv_heads=8, tie_word_embeddings=False,
                 rms_norm_eps=1e-5)
        d.update(kw)
        return ModelConfig(**d)

    @staticmethod
    def llama3_8b(**kw) -> "ModelConfig":
        """Llama-3.1-8B geometry (the EAGLE serving target)."""
        d = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                 num_layers=32, num_heads=32, num_kv_heads=8,
                 rope_theta=500000.0, rms_norm_eps=1e-5,
                 tie_word_embeddings=False, attention_bias=False,
                 eos_token_id=128009)
        d.update(kw)
        return ModelConfig(**d)

    @staticmethod
    def tiny(vocab_size: int = 256, **kw) -> "ModelConfig":
        """Tiny float32 config for tests (random weights)."""
        d = dict(vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
                 num_layers=2, num_heads=4, num_kv_heads=2,
                 dtype=torch.float32, eos_token_id=vocab_size - 1)
        d.update(kw)
        return ModelConfig(**d)


@dataclasses.dataclass(frozen=True)
class VerifierConfig:
    """Which acceptance rule to run and its knobs.

    method: 'tokenwise' | 'blockwise' | 'hsd' | 'hsd_ref' | 'greedy'.
    num_drafts: K independent drafts (parallel multidraft). 1 = one draft.
    parallel: True = K independent full drafts with prefix-match gating.
      The striped layout (False) is not ported yet.
    """

    method: str = "hsd"
    gamma: int = 10
    num_drafts: int = 1
    parallel: bool = True


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    verifier: VerifierConfig = VerifierConfig()
    max_new_tokens: int = 512
    temperature: float = 1.0
    # logits-processor knobs, applied identically to draft and target
    top_k: int = 0
    top_p: float = 1.0
