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
to end (--dtype float32 for an f32 model, e.g. to compare --tp runs on the
CPU). --tokenizer-path (a local directory) needs the `transformers`
package; without it the byte tokenizer runs.

Tensor parallelism: --tp N runs as N processes, one a card, each the
whole engine loop on its Megatron shard of the target (parallel/tp.py)
with the draft replicated, e.g. on a machine with N cards

  torchrun --nproc-per-node N hsd_tpu_torch/tools/run_gsm8k.py --tp N ...

(NCCL). --tp-mode shardmap shards as `tp.shard_params_tp` (the embedding
replicated), gspmd as `sharding.shard_params` (the embedding
vocab-sharded); both run the same explicit-collective forward with the
kernels on the local shards. Rank 0 alone writes the artifacts and
prints.
"""
import argparse
import dataclasses
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


def parallel_setup(dp: int = 1, tp: int = 1):
    """(rank, mesh) of a --dp / --tp run: the process group from torchrun's
    environment (a no-op in one process), a (dp, tp) grid of the world's
    ranks, or no mesh for one process."""
    import torch.distributed as dist
    from hsd_tpu_torch.parallel import initialize_multihost, make_mesh
    rank = initialize_multihost()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != dp * tp:
        raise SystemExit(f"--dp {dp} --tp {tp} runs as {dp * tp} processes "
                         f"(torchrun --nproc-per-node {dp * tp}); the world "
                         f"has {world}")
    return rank, (make_mesh(dp, tp) if world > 1 else None)


def tp_target(cfg_t, params_t, mesh, mode: str = "gspmd"):
    """(this rank's target shard, make_generate's target_forward and
    target_cache_ops) for --tp-mode gspmd or shardmap; the plain target
    without a mesh."""
    if mesh is None:
        return params_t, None, None
    from hsd_tpu_torch.parallel import sharding, tp
    local = (tp.shard_params_tp(params_t, mesh) if mode == "shardmap"
             else sharding.shard_params(params_t, mesh))
    return (local, tp.make_tp_target_forward(cfg_t, params_t, mesh),
            tp.tp_cache_ops(cfg_t, mesh))


def rank_out_dir(rank: int, out_dir: str):
    """Rank 0's outputs go to out_dir; another rank's to a temporary
    directory, deleted with the context (its artifacts are rank 0's)."""
    import contextlib
    import tempfile
    if rank == 0:
        return contextlib.nullcontext(out_dir)
    return tempfile.TemporaryDirectory(prefix=f"rank{rank}_")


def geometry(name: str, dtype: str = None, **kw):
    """A ModelConfig preset, with --dtype's activation dtype if given."""
    import dataclasses
    import torch
    from hsd_tpu_torch.config import ModelConfig
    cfg = getattr(ModelConfig, name)(**kw)
    return cfg if dtype is None else dataclasses.replace(
        cfg, dtype=getattr(torch, dtype))


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
                    help="tensor-parallel size: run under torchrun "
                         "--nproc-per-node TP")
    ap.add_argument("--tp-mode", default="gspmd",
                    choices=["gspmd", "shardmap"],
                    help="gspmd: sharding.shard_params (vocab-sharded "
                         "embedding); shardmap: tp.shard_params_tp "
                         "(replicated embedding)")
    ap.add_argument("--dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="activation dtype of random geometries (default: "
                         "the preset's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    rank, mesh = parallel_setup(tp=args.tp)

    from hsd_tpu_torch.config import EngineConfig, VerifierConfig
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
        cfg_t = geometry(args.target_geometry, args.dtype)
        params_t = init_params(cfg_t, seed=1, device=dev)
    if args.draft_path:
        cfg_d, params_d = load_hf(args.draft_path, device=dev)
    else:
        cfg_d = geometry(args.draft_geometry, args.dtype,
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
    params_t, tfwd, tops = tp_target(cfg_t, params_t, mesh, args.tp_mode)
    with rank_out_dir(rank, args.out_dir) as out_dir:
        summary = run_eval(cfg_d, cfg_t, params_d, params_t, tok, qs, shots,
                           dataclasses.replace(ev, out_dir=out_dir),
                           target_forward=tfwd, target_cache_ops=tops,
                           device=dev)
    # raw model answers live in the answers artifact; keep the console
    # summary readable
    summary.pop("model_answers", None)
    if rank == 0:
        print(json.dumps(summary, indent=2, default=str))
    return summary


if __name__ == "__main__":
    main()
