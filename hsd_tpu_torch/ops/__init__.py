"""Compute ops: linear/quantized matmul, the CUDA kernels, sampling.

Every kernel wrapper counts its launches (`<wrapper>.launches`);
`launch_counts()` reads them all by kernel name (K1-K8, K7i4, and route
A's `dequantize_int4` / `dequantize_int8`) and `reset_launches()` zeroes
them."""
from . import flash_decode, gptq_cuda
from .linear import QuantizedLinear, apply_linear, dequantize, quantize

__all__ = ["QuantizedLinear", "apply_linear", "dequantize", "quantize",
           "launch_counts", "reset_launches"]

_WRAPPERS = {**gptq_cuda.WRAPPERS, **flash_decode.WRAPPERS}


def launch_counts() -> dict:
    return {k: _WRAPPERS[k].launches for k in sorted(_WRAPPERS)}


def reset_launches() -> None:
    for w in _WRAPPERS.values():
        w.launches = 0
