"""Model stack: the unified Qwen2/Llama decoder."""
from . import transformer
from .transformer import ModelParams, forward, init_params

__all__ = ["transformer", "ModelParams", "forward", "init_params"]
