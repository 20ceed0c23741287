"""Synthetic coupled draft/target pairs."""
from .synthetic import (CoupledCache, CoupledParams, build_coupled_pair,
                        init_quantized_params, make_coupled_target,
                        quantize_draft)

__all__ = ["CoupledCache", "CoupledParams", "build_coupled_pair",
           "init_quantized_params", "make_coupled_target", "quantize_draft"]
