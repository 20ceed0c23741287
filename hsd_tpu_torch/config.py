"""Typed configuration for models, verification and the decode engine.

The PyTorch port's own copy of `hsd_tpu/config.py`: the same fields and
presets, with `dtype` a `torch.dtype`. The GPTQ path knob (`gptq_path`) and
the mesh config of the JAX package are left out: on a CUDA tensor every
quantized matmul runs its hand-written kernel, and the port runs on one
card. `gptq_mxu_bf16` stays, because it changes the numerics. Fields
that nothing reads (`mlp_bias` and `max_position_embeddings`, which the
JAX package declares and never reads either, and the engine's max_seq_len
and seed) are left out, so that setting one cannot quietly give a
different model.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Decoder-only transformer config covering the Qwen2/2.5, Llama and
    Mixtral families."""

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
    # sparse mixture-of-experts (Mixtral): num_experts == 0 is a dense MLP
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # bf16 operands with f32 accumulation in the quantized products at
    # 129-1024 rows (slot-batched serving, where they are bound by
    # operations): symmetric int8 weights there run the tensor-core kernel
    # K7. Off by default: the decode matvec keeps exact f32 operands.
    gptq_mxu_bf16: bool = False

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

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
    def mixtral_8x7b(**kw) -> "ModelConfig":
        """Mixtral-8x7B geometry: 8 experts, top-2."""
        d = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                 num_layers=32, num_heads=32, num_kv_heads=8,
                 rope_theta=1e6, rms_norm_eps=1e-5,
                 tie_word_embeddings=False, attention_bias=False,
                 eos_token_id=2, num_experts=8, num_experts_per_tok=2)
        d.update(kw)
        return ModelConfig(**d)

    @staticmethod
    def tiny_moe(vocab_size: int = 256, **kw) -> "ModelConfig":
        """Tiny float32 Mixtral-style config for tests."""
        d = dict(num_experts=4, num_experts_per_tok=2, attention_bias=False)
        d.update(kw)
        return ModelConfig.tiny(vocab_size=vocab_size, **d)

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
    num_drafts: K drafts (multidraft). 1 = one draft.
    parallel: True = K independent full drafts with prefix-match gating.
      False (K > 1) = the striped tree: R = 1 + gamma * (K - 1) draft rows,
      the primary and gamma groups of K - 1 branch rows, group j mirroring
      the primary through position j - 1 and sampling its own token at
      position j; round b verifies row n_matches * (K - 1) + b, gated on
      the accepted prefix still following the primary (exact for tokenwise
      and hsd; hsd_ref keeps the reference's ungated rows).
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
