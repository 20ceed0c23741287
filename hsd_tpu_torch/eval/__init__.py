"""Synthetic coupled draft/target pairs."""
from .synthetic import (CoupledCache, CoupledEagleParams, CoupledParams,
                        build_coupled_eagle_pair, build_coupled_pair,
                        init_quantized_params, make_coupled_eagle_target,
                        make_coupled_target, quantize_draft)

__all__ = ["CoupledCache", "CoupledEagleParams", "CoupledParams",
           "build_coupled_eagle_pair", "build_coupled_pair",
           "init_quantized_params", "make_coupled_eagle_target",
           "make_coupled_target", "quantize_draft"]
