"""Evaluation harnesses and metrics (GSM8K, multi-bench, BE/DS/accuracy),
the realistic oracle pair (`oracle`) and synthetic coupled draft/target
pairs (`synthetic`)."""
# synthetic first: it loads the engine package before the models, the order
# their imports of each other need
from .synthetic import (CoupledCache, CoupledEagleParams, CoupledParams,
                        build_coupled_eagle_pair, build_coupled_pair,
                        init_quantized_params, make_coupled_eagle_target,
                        make_coupled_target, quantize_draft)
from .benches import (ChatTemplate, get_system_prompt, load_bench_questions,
                      reorg_answer_file, run_multibench)
from .metrics import (accuracy, block_efficiency, decoding_speed,
                      extract_answer, summarize, test_answer)

__all__ = ["accuracy", "block_efficiency", "decoding_speed", "extract_answer",
           "summarize", "test_answer", "ChatTemplate", "get_system_prompt",
           "load_bench_questions", "reorg_answer_file", "run_multibench",
           "CoupledCache", "CoupledEagleParams", "CoupledParams",
           "build_coupled_eagle_pair", "build_coupled_pair",
           "init_quantized_params", "make_coupled_eagle_target",
           "make_coupled_target", "quantize_draft"]
