"""Model stack: the unified Qwen2/Llama/Mixtral decoder, the EAGLE draft
head and the HF checkpoint loader (`loader`)."""
from . import eagle, transformer
from .transformer import ModelParams, forward, init_params

__all__ = ["eagle", "transformer", "ModelParams", "forward", "init_params"]
