"""Model stack: the unified Qwen2/Llama decoder and the EAGLE draft head."""
from . import eagle, transformer
from .transformer import ModelParams, forward, init_params

__all__ = ["eagle", "transformer", "ModelParams", "forward", "init_params"]
