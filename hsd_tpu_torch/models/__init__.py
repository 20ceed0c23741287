"""Model stack: the unified Qwen2/Llama/Mixtral decoder, the EAGLE draft
head and the HF checkpoint loader (`loader`)."""
# the engine package first: models.transformer and engine.server import
# each other's modules, which works in this order only
from .. import engine  # noqa: F401
from . import eagle, transformer
from .transformer import ModelParams, forward, init_params

__all__ = ["eagle", "transformer", "ModelParams", "forward", "init_params"]
