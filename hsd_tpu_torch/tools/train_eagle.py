#!/usr/bin/env python
"""EAGLE draft-head training CLI on the port (the counterpart of
`scripts/train_eagle.py`, with the same flags and `--device`):
conversation jsonl -> train/data.py pipeline -> the eagle1 / eagle3 train
step over a frozen target -> `torch.save` checkpoints with auto-resume.

Examples:
  # EAGLE-3 head on a ShareGPT jsonl, tiny geometry on the CPU
  python hsd_tpu_torch/tools/train_eagle.py --data conv.jsonl \\
      --geometry tiny --epochs 1 --batch-size 2 --device cpu
  # EAGLE-1 legacy head over an 8B checkpoint directory, on the card
  python hsd_tpu_torch/tools/train_eagle.py --version 1 --data conv.jsonl \\
      --target-path /ckpts/llama3-8b --ckpt-dir ckpts/eagle1
  # dump the target's features once, then train from the dump
  python hsd_tpu_torch/tools/train_eagle.py --data conv.jsonl \\
      --dump-features feats/ --device cpu
  python hsd_tpu_torch/tools/train_eagle.py --features-dir feats/ --device cpu

Without --target-path, random weights of --geometry run the whole pipeline
(the loss is meaningless but every stage is real). --target-path goes
through the port's `load_hf`; --tokenizer-path takes a local directory and
needs the `transformers` package, else the byte tokenizer runs. --dp or
--tp above 1 is not ported yet (ROADMAP.md §1.10). Without --device the
run needs the card.
"""
import argparse
import itertools
import json
import sys
from pathlib import Path

if __package__ in (None, ""):            # run as a script from its path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from hsd_tpu_torch.tools.run_gsm8k import load_tokenizer


def no_mesh(dp: int, tp: int) -> None:
    if dp * tp > 1:
        raise NotImplementedError(
            "data / tensor parallelism (--dp or --tp > 1) is not ported to "
            "PyTorch yet: ROADMAP.md §1.10")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None,
                    help="ShareGPT-style conversations jsonl/json "
                         "(required unless --features-dir)")
    ap.add_argument("--version", type=int, default=3, choices=[1, 3])
    ap.add_argument("--target-path", default=None)
    ap.add_argument("--geometry", default="tiny")
    ap.add_argument("--eagle-config", default=None,
                    help="EConfig JSON (EagleConfig.from_json)")
    ap.add_argument("--template", default="qwen",
                    choices=["qwen", "llama3", "plain"])
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--buckets", default="256,512,1024,2048")
    ap.add_argument("--system", default=None,
                    help="system prompt override (default: the reference's "
                         "training system prompt; shorten for byte-tokenizer "
                         "smokes with small buckets)")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every-epochs", type=int, default=1)
    ap.add_argument("--log-jsonl", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--kacc-probe", action="store_true",
                    help="between-epoch getkacc rollout probe (ref "
                         "train/main.py:420-424)")
    ap.add_argument("--steps-per-epoch", type=int, default=0,
                    help="0 = full epoch; >0 truncates (smoke runs)")
    ap.add_argument("--dump-features", default=None, metavar="DIR",
                    help="run the target ONCE over the data, write feature "
                         "shards to DIR (ref CustomDataset pre-dump, "
                         "train/main.py:133-172), then exit")
    ap.add_argument("--features-dir", default=None, metavar="DIR",
                    help="train FROM a feature dump: no target forward in "
                         "the step (--data is ignored)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    no_mesh(args.dp, args.tp)

    from hsd_tpu_torch.config import ModelConfig
    from hsd_tpu_torch.engine.eagle_engine import default_feature_layers
    from hsd_tpu_torch.eval.benches import ChatTemplate
    from hsd_tpu_torch.models import init_params
    from hsd_tpu_torch.models.eagle import (EagleConfig, init_eagle_params,
                                            init_eagle_params_v1)
    from hsd_tpu_torch.models.transformer import resolve_device
    from hsd_tpu_torch.train import eagle1, eagle3, features
    from hsd_tpu_torch.train.data import conversation_data_epochs
    from hsd_tpu_torch.train.loop import train_loop
    from hsd_tpu_torch.utils.logging import MetricLogger

    dev = resolve_device(args.device)
    if args.target_path:
        from hsd_tpu_torch.models.loader import load_hf
        cfg_t, params_t = load_hf(args.target_path, device=dev)
    else:
        cfg_t = getattr(ModelConfig, args.geometry)()
        params_t = init_params(cfg_t, seed=0, device=dev)

    if args.eagle_config:
        ecfg = EagleConfig.from_json(args.eagle_config, version=args.version)
    else:
        ecfg = EagleConfig(
            hidden_size=cfg_t.hidden_size,
            target_hidden_size=cfg_t.hidden_size,
            num_heads=cfg_t.num_heads, num_kv_heads=cfg_t.num_kv_heads,
            vocab_size=cfg_t.vocab_size, draft_vocab_size=cfg_t.vocab_size,
            intermediate_size=cfg_t.intermediate_size,
            rope_theta=cfg_t.rope_theta, dtype=cfg_t.dtype,
            version=args.version)

    tok = load_tokenizer(args.tokenizer_path)

    if args.features_dir:
        meta = features.offline_meta(args.features_dir)
        if meta["version"] != args.version:
            raise SystemExit(f"feature dump is version {meta['version']}, "
                             f"requested --version {args.version}")
        de = features.offline_data_epochs(args.features_dir, device=dev)
    else:
        if not args.data:
            raise SystemExit("--data required unless --features-dir")
        buckets = tuple(int(b) for b in args.buckets.split(","))
        kw = {"system": args.system} if args.system is not None else {}
        de_full = conversation_data_epochs(
            args.data, tok, args.batch_size,
            ChatTemplate(style=args.template),
            max_len=args.max_len, buckets=buckets, **kw)
        if args.steps_per_epoch:
            de = lambda e: itertools.islice(de_full(e), args.steps_per_epoch)
        else:
            de = de_full

    if args.dump_features:
        fl = (default_feature_layers(cfg_t) if args.version == 3 else None)
        n = features.dump_features(cfg_t, params_t, de(0), args.dump_features,
                                   feature_layers=fl, version=args.version,
                                   device=dev)
        print(json.dumps({"dumped_shards": n, "dir": args.dump_features,
                          "version": args.version}))
        return

    # steps estimate for the warmup/decay schedule (first epoch's count)
    n_batches = sum(1 for _ in de(0))
    if not n_batches:
        raise SystemExit("data pipeline produced no batches")
    total = n_batches * args.epochs
    tc = eagle3.TrainConfig(total_steps=total,
                            warmup_steps=max(1, total // 20),
                            **({"lr": args.lr} if args.lr else {}))

    if args.version == 1:
        params_e = init_eagle_params_v1(ecfg, seed=1, device=dev)
        step = (eagle1.make_eagle1_train_step_offline(cfg_t, ecfg, tc)
                if args.features_dir
                else eagle1.make_eagle1_train_step(cfg_t, ecfg, tc))
    else:
        params_e = init_eagle_params(ecfg, seed=1, device=dev)
        step = (eagle3.make_train_step_offline(cfg_t, ecfg, tc)
                if args.features_dir
                else eagle3.make_train_step(cfg_t, ecfg, tc,
                                            default_feature_layers(cfg_t)))
    state = eagle3.init_train_state(params_e, tc)

    probe = None
    if args.kacc_probe:
        from hsd_tpu_torch.train.probes import make_kacc_probe
        probe = make_kacc_probe(cfg_t, ecfg)

    logger = MetricLogger(args.log_jsonl) if args.log_jsonl else None
    state = train_loop(state, step, params_t, de, args.epochs,
                       ckpt_dir=args.ckpt_dir,
                       save_every_epochs=args.save_every_epochs,
                       logger=logger, log_every=args.log_every,
                       epoch_probe=probe)
    if logger is not None:
        logger.close()
    print(json.dumps({"final_step": state.step,
                      "epochs": args.epochs, "batches_per_epoch": n_batches,
                      "ckpt_dir": args.ckpt_dir}))


if __name__ == "__main__":
    main()
