#!/usr/bin/env python
"""Multi-benchmark eval CLI on the port (mt_bench / humaneval / alpaca / qa
/ sum / gsm8k / flores200 / cnndailymail; the counterpart of
`scripts/run_bench.py`, with the same flags and `--device`).

Counterpart of the reference's per-model eval drivers
(`EAGLE-3H/eagle/evaluation/gen_ea_answer_*.py`): loads a bench's question
file, drives either the speculative (draft+target) engine or the EAGLE trie
engine, and writes the reference's two artifacts — an answers jsonl and a
`*_info.jsonl` consumed by `hsd_tpu_torch.eval.eagle_metrics`.

Examples:
  # EAGLE+HSD on mt_bench (reference headline EAGLE config)
  python hsd_tpu_torch/tools/run_bench.py --engine eagle \\
      --bench-name mt_bench --question-file data/mt_bench/question.jsonl \\
      --mode hsd
  # draft+target HSD on humaneval, 2-way sharded (process 0 of 2)
  python hsd_tpu_torch/tools/run_bench.py --bench-name humaneval \\
      --question-file question.jsonl --method hsd --shard 0/2
  # on the CPU at a tiny size
  python hsd_tpu_torch/tools/run_bench.py --question-file \\
      data/mt_bench/question.jsonl --target-geometry tiny \\
      --draft-geometry tiny --max-new-tokens 8 --warmup 0 --device cpu

Without --*-path flags, random weights of the chosen geometry run the whole
pipeline. --eagle-path is an EAGLE-3 head directory (its config.json and
safetensors). After sharded runs appending to one answers file, pass
--reorg to sort + dedup it (ref reorg_answer_file). --tokenizer-path needs
the `transformers` package. --tp N runs as N processes (torchrun
--nproc-per-node N ... --tp N), the target in the GSPMD layout
(`sharding.shard_params`) on every engine, the draft or the head
replicated; rank 0 alone writes and prints (see tools/run_gsm8k.py).
"""
import argparse
import json
import os
import sys
from pathlib import Path

if __package__ in (None, ""):            # run as a script from its path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from hsd_tpu_torch.tools.run_gsm8k import (geometry, load_tokenizer,
                                           parallel_setup, rank_out_dir,
                                           tp_target)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench-name", default="mt_bench",
                    choices=["mt_bench", "alpaca", "qa", "sum", "humaneval",
                             "gsm8k", "flores200", "cnndailymail"])
    ap.add_argument("--question-file", required=True)
    ap.add_argument("--question-begin", type=int, default=None)
    ap.add_argument("--question-end", type=int, default=None)
    ap.add_argument("--shard", default=None, help="i/n question shard")
    ap.add_argument("--engine", default="spec", choices=["spec", "eagle"])
    # spec engine
    ap.add_argument("--method", default="hsd",
                    choices=["tokenwise", "blockwise", "hsd", "hsd_ref",
                             "greedy"])
    ap.add_argument("--gamma", type=int, default=10)
    ap.add_argument("--num-drafts", type=int, default=1)
    ap.add_argument("--draft-path", default=None)
    ap.add_argument("--draft-geometry", default="qwen2_05b")
    # eagle engine
    ap.add_argument("--mode", default="hsd",
                    choices=["greedy", "typical", "hsd"])
    ap.add_argument("--eagle-path", default=None)
    ap.add_argument("--total-tokens", type=int, default=59)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--top-k", type=int, default=10)
    # shared
    ap.add_argument("--target-path", default=None)
    ap.add_argument("--target-geometry", default="qwen2_05b")
    ap.add_argument("--target-bits", type=int, default=0)
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--template", default="qwen",
                    choices=["qwen", "llama3", "plain"])
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--max-new-tokens", type=int, default=512)
    ap.add_argument("--num-choices", type=int, default=1)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-id", default="hsd_tpu")
    ap.add_argument("--out-dir", default="bench_out")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel size: run under torchrun "
                         "--nproc-per-node TP")
    ap.add_argument("--dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="activation dtype of random geometries (default: "
                         "the preset's)")
    ap.add_argument("--flores-source", default="eng_Latn")
    ap.add_argument("--flores-target", default="fra_Latn")
    ap.add_argument("--reorg", default=None,
                    help="answers jsonl to sort+dedup, then exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from hsd_tpu_torch.eval.benches import (ChatTemplate,
                                            load_bench_questions,
                                            reorg_answer_file, run_multibench)

    if args.reorg:
        reorg_answer_file(args.reorg)
        print(f"reorganized {args.reorg}")
        return None
    rank, mesh = parallel_setup(tp=args.tp)

    from hsd_tpu_torch.config import EngineConfig, VerifierConfig
    from hsd_tpu_torch.eval.eagle_metrics import evaluate_info_file
    from hsd_tpu_torch.models import init_params
    from hsd_tpu_torch.models.loader import load_hf
    from hsd_tpu_torch.models.transformer import resolve_device

    dev = resolve_device(args.device)
    kw = {}
    if args.bench_name == "flores200":
        kw = dict(source_lang=args.flores_source,
                  target_lang=args.flores_target)
    questions = load_bench_questions(
        args.bench_name, args.question_file, args.question_begin,
        args.question_end, shard=args.shard, **kw)

    if args.target_path:
        cfg_t, params_t = load_hf(args.target_path,
                                  quantized=args.target_bits or None,
                                  device=dev)
    else:
        cfg_t = geometry(args.target_geometry, args.dtype)
        params_t = init_params(cfg_t, seed=1, device=dev)

    eng = EngineConfig(
        verifier=VerifierConfig(method=args.method, gamma=args.gamma,
                                num_drafts=args.num_drafts),
        max_new_tokens=args.max_new_tokens, temperature=args.temperature)

    if args.engine == "eagle":
        from hsd_tpu_torch.engine.eagle_engine import make_eagle_generate
        from hsd_tpu_torch.models.eagle import EagleConfig, init_eagle_params
        if args.eagle_path:
            from hsd_tpu_torch.models.loader import load_eagle_hf
            # the head's own config.json (the JAX CLI unpacks the loader's
            # EagleParams as a (config, params) pair, which raises)
            ecfg = EagleConfig.from_json(
                os.path.join(args.eagle_path, "config.json"),
                top_k=args.top_k, depth=args.depth,
                total_tokens=args.total_tokens)
            params_e = load_eagle_hf(args.eagle_path, params_t.embed,
                                     dtype=ecfg.dtype, device=dev)
        else:
            ecfg = EagleConfig(
                hidden_size=cfg_t.hidden_size,
                target_hidden_size=cfg_t.hidden_size,
                num_heads=cfg_t.num_heads, num_kv_heads=cfg_t.num_kv_heads,
                vocab_size=cfg_t.vocab_size,
                draft_vocab_size=cfg_t.vocab_size,
                intermediate_size=cfg_t.intermediate_size,
                top_k=args.top_k, depth=args.depth,
                total_tokens=args.total_tokens, dtype=cfg_t.dtype)
            params_e = init_eagle_params(ecfg, seed=2, device=dev)
        tfwd = tinit = None
        if mesh is not None:
            from hsd_tpu_torch.engine.eagle_engine import (
                default_feature_layers)
            from hsd_tpu_torch.parallel import tp
            feats = ((-1,) if ecfg.version == 1
                     else default_feature_layers(cfg_t))
            tfwd = tp.make_tp_eagle_forward(cfg_t, params_t, feats, mesh)
            tinit = tp.tp_cache_init(cfg_t, mesh)
            params_t, _, _ = tp_target(cfg_t, params_t, mesh)
        gen_fn = make_eagle_generate(cfg_t, ecfg, eng, mode=args.mode,
                                     target_forward=tfwd,
                                     target_cache_init=tinit)
        generate = lambda p, n, g: gen_fn(params_t, params_e, p, n, g)
        gamma = ecfg.total_tokens
    else:
        from hsd_tpu_torch.engine import make_generate
        if args.draft_path:
            cfg_d, params_d = load_hf(args.draft_path, device=dev)
        else:
            cfg_d = geometry(args.draft_geometry, args.dtype,
                             vocab_size=cfg_t.vocab_size)
            params_d = init_params(cfg_d, seed=0, device=dev)
        params_t, tfwd, tops = tp_target(cfg_t, params_t, mesh)
        gen_fn = make_generate(cfg_d, cfg_t, eng, target_forward=tfwd,
                               target_cache_ops=tops)
        generate = lambda p, n, g: gen_fn(params_d, params_t, p, n, g)
        gamma = args.gamma

    tok = load_tokenizer(args.tokenizer_path)
    tag = args.tag or f"{args.bench_name}_{args.model_id}"
    if args.shard:
        tag += "_shard" + args.shard.replace("/", "of")
    with rank_out_dir(rank, args.out_dir) as out_dir:
        summary = run_multibench(
            questions, tok, generate, out_dir, tag,
            bench_name=args.bench_name, model_id=args.model_id,
            num_choices=args.num_choices, warmup=args.warmup, seed=args.seed,
            template=ChatTemplate(style=args.template), device=dev)
        metrics = evaluate_info_file(summary["info"], gamma=gamma)
    out = {**summary, "metrics": metrics}
    if rank == 0:
        print(json.dumps(out, indent=2, default=str))
    return out


if __name__ == "__main__":
    main()
