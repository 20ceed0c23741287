#!/usr/bin/env python
"""GSM8K speculative-decoding evaluation CLI on the port (the counterpart
of `scripts/run_gsm8k.py`, with the same flags and `--device`).

The counterpart of the reference's `eval_speculative_decoding_llm.py` +
`eval_speculative_qwen*.sh` run matrix: drives a draft + target pair
through the speculative engine over a GSM8K slice and reports accuracy /
block efficiency / decoding speed, writing the same artifact shapes.

Examples (the reference's four shipped configs):
  # tokenwise baseline
  python hsd_tpu_torch/tools/run_gsm8k.py --method tokenwise --gamma 10 ...
  # HSD clever (the headline config)
  python hsd_tpu_torch/tools/run_gsm8k.py --method hsd --gamma 10 ...
  # multidraft 11 parallel, tokenwise or HSD
  python hsd_tpu_torch/tools/run_gsm8k.py --method hsd --num-drafts 11 ...
  # on the CPU at a tiny size
  python hsd_tpu_torch/tools/run_gsm8k.py --data data/gsm8k/question.jsonl \\
      --stride 1 --draft-geometry tiny --target-geometry tiny \\
      --max-new-tokens 16 --device cpu

Weights: --draft-path/--target-path are HF checkpoint dirs (safetensors;
GPTQ via --target-bits 8|4), read by `hsd_tpu_torch/models/loader.py`.
Without paths, random weights of the given geometry run the pipeline end
to end. --tokenizer-path (a local directory) needs the `transformers`
package; without it the byte tokenizer runs. --tp above 1 is not ported
yet (ROADMAP.md §1.10).
"""
import argparse
import json
import os
import sys
from pathlib import Path

if __package__ in (None, ""):            # run as a script from its path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def load_tokenizer(path):
    """An HF tokenizer from a local directory, else the byte tokenizer."""
    if not path:
        from hsd_tpu_torch.eval.gsm8k import ByteTokenizer
        return ByteTokenizer()
    if not os.path.isdir(path):
        raise SystemExit(f"--tokenizer-path {path}: not a local directory")
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise SystemExit(
            f"--tokenizer-path needs the `transformers` package ({e}); "
            "leave the flag out to use the byte tokenizer") from e
    return AutoTokenizer.from_pretrained(path, local_files_only=True)


def no_tp(tp: int) -> None:
    if tp > 1:
        raise NotImplementedError(
            "tensor parallelism (--tp > 1) is not ported to PyTorch yet: "
            "ROADMAP.md §1.10")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True, help="GSM8K test.jsonl path")
    ap.add_argument("--prompt-file", default=None,
                    help="explicit few-shot CoT prompt text file (overrides "
                         "--prompt)")
    ap.add_argument("--prompt", default="original",
                    help="packaged prompt-library variant stem "
                         "(hsd_tpu_torch/eval/lib_prompt/prompt_<NAME>.txt): "
                         "original, hardest (the reference harness default), "
                         "easy/mid/hard, semicolon/exclamation/explicit/"
                         "no_break, simple_4_cases[_ao], 8x8step/6_9step/..., "
                         "short/mid_length/long_questions, longest, random")
    ap.add_argument("--draft-path", default=None)
    ap.add_argument("--target-path", default=None)
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--draft-geometry", default="qwen2_05b")
    ap.add_argument("--target-geometry", default="qwen2_15b")
    ap.add_argument("--target-bits", type=int, default=0,
                    help="8/4 for GPTQ target checkpoints")
    ap.add_argument("--method", default="hsd",
                    choices=["tokenwise", "blockwise", "hsd", "hsd_ref",
                             "greedy"])
    ap.add_argument("--gamma", type=int, default=10)
    ap.add_argument("--num-drafts", type=int, default=1)
    ap.add_argument("--striped", action="store_true",
                    help="striped-tree multidraft (default: parallel)")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--max-new-tokens", type=int, default=512)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--stride", type=int, default=5,
                    help="question stride (ref uses every 5th)")
    ap.add_argument("--out-dir", default="gsm8k_out")
    ap.add_argument("--tag", default="run")
    ap.add_argument("--shard", default=None,
                    help="i/n — evaluate the i-th of n question shards "
                         "(one process per shard)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel size (not ported: 1 only)")
    ap.add_argument("--tp-mode", default="gspmd",
                    choices=["gspmd", "shardmap"],
                    help="the JAX CLI's TP mode (not ported)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    no_tp(args.tp)

    from hsd_tpu_torch.config import (EngineConfig, ModelConfig,
                                      VerifierConfig)
    from hsd_tpu_torch.eval.gsm8k import (EvalConfig, default_prompt_path,
                                          load_gsm8k_jsonl, run_eval)
    from hsd_tpu_torch.models import init_params
    from hsd_tpu_torch.models.loader import align_vocab, load_hf
    from hsd_tpu_torch.models.transformer import resolve_device

    dev = resolve_device(args.device)
    if args.target_path:
        cfg_t, params_t = load_hf(args.target_path,
                                  quantized=args.target_bits or None,
                                  device=dev)
    else:
        cfg_t = getattr(ModelConfig, args.target_geometry)()
        params_t = init_params(cfg_t, seed=1, device=dev)
    if args.draft_path:
        cfg_d, params_d = load_hf(args.draft_path, device=dev)
    else:
        cfg_d = getattr(ModelConfig, args.draft_geometry)(
            vocab_size=cfg_t.vocab_size)
        params_d = init_params(cfg_d, seed=0, device=dev)

    if cfg_d.vocab_size != cfg_t.vocab_size:
        # Qwen2.5 pairs ship mismatched vocab widths (0.5B: 151936 vs 14B+:
        # 152064); truncate both to the common min like the reference
        # (eval_speculative_decoding_llm.py:140-198)
        cfg_d, params_d, cfg_t, params_t = align_vocab(
            cfg_d, params_d, cfg_t, params_t)

    tok = load_tokenizer(args.tokenizer_path)
    prompt_file = args.prompt_file or default_prompt_path(args.prompt)
    with open(prompt_file) as f:
        shots = f.read()
    qs = load_gsm8k_jsonl(args.data, limit=args.limit or None,
                          stride=args.stride)
    if args.shard:
        i, nsh = map(int, args.shard.split("/"))
        qs = qs[i::nsh]

    ev = EvalConfig(
        engine=EngineConfig(
            verifier=VerifierConfig(method=args.method, gamma=args.gamma,
                                    num_drafts=args.num_drafts,
                                    parallel=not args.striped),
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature),
        out_dir=args.out_dir, tag=args.tag)
    summary = run_eval(cfg_d, cfg_t, params_d, params_t, tok, qs, shots, ev,
                       device=dev)
    # raw model answers live in the answers artifact; keep the console
    # summary readable
    summary.pop("model_answers", None)
    print(json.dumps(summary, indent=2, default=str))
    return summary


if __name__ == "__main__":
    main()
