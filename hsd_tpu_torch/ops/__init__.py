"""Compute ops: linear/quantized matmul, the CUDA kernels, sampling."""
from .linear import QuantizedLinear, apply_linear, dequantize, quantize

__all__ = ["QuantizedLinear", "apply_linear", "dequantize", "quantize"]
