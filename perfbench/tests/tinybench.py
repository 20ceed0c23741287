"""A benchmark written to a temporary directory at a size the CPU runs in
seconds: a configuration, a mix, a cell and a per-layer metric that the
repository's benchmark does not have, found by name with no edit to any
file of the harness."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
REPO = PKG.parent

CONFIG = {
    "name": "tiny-pair", "hidden_size": 128, "intermediate_size": 256,
    "num_hidden_layers": 2, "num_attention_heads": 2,
    "num_key_value_heads": 1, "vocab_size": 1024, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
    "eos_token_id": 1000, "attention_bias": True,
    "draft": {"hidden_size": 128, "intermediate_size": 256,
              "num_hidden_layers": 2, "num_attention_heads": 2,
              "num_key_value_heads": 1, "vocab_size": 1024,
              "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
              "tie_word_embeddings": True, "attention_bias": True,
              "quantization_config": {"bits": 8, "sym": True}},
    "coupling": {"logit_scale": 1.467, "lam": 0.3}}
# the MoE pair's draft is asymmetric int8, so both int8 forms are run
MOE = dict(CONFIG, name="tiny-moe", num_local_experts=4,
           num_experts_per_tok=2, attention_bias=False,
           draft=dict(CONFIG["draft"],
                      quantization_config={"bits": 8, "sym": False}))
MIX = {"clients": 5, "warmup_completions": 2, "bucket": 32,
       "shared_prefix": 8,
       "prompt": {"median": 8, "sigma": 0.4, "min": 4, "max": 20},
       "output": {"median": 12, "sigma": 0.4, "min": 4, "max": 24},
       "pool": 16}
# a sound tiny run reads under half of these (bf16 at D 128), the half-batch
# fault ~0.19 in target_tv, the float8 control ~0.6 in big_logit_err
LIMITS = {"draft_tv": 0.12, "target_tv": 0.12, "big_logit_err": 0.15,
          "commit_off": 0, "harvest_off": 0}
WORKLOAD = {"engine": {"slots": 4, "admit_batch": 2, "steps_per_dispatch": 2,
                       "method": "hsd", "gamma": 3, "num_drafts": 1,
                       "temperature": 1.0},
            "limits": LIMITS}
METRIC = '''"""blocks.count: pool blocks in the traced slice."""


def read(ctx):
    return float(ctx.blocks)
'''


def make_root(tmp: Path, extra=(), files=None) -> Path:
    """tmp/BENCHMARK.json and tmp/perfbench/ with the repository's metric
    readers and one new of each piece; returns tmp. extra: further
    configurations [(sizes, the text of their `.py`, or None for the
    repository's)], each with a cell `<name>.mini`; files: further files
    {path under perfbench/: text}."""
    pb = tmp / "perfbench"
    for d in ("configs", "traffic", "workloads", "metrics"):
        (pb / d).mkdir(parents=True)
    for f in (PKG / "metrics").glob("*.py"):
        shutil.copy(f, pb / "metrics" / f.name)
    (pb / "metrics" / "blocks.count.py").write_text(METRIC)
    for rel, text in (files or {}).items():
        (pb / rel).parent.mkdir(parents=True, exist_ok=True)
        (pb / rel).write_text(text)
    configs = [(CONFIG, None), (MOE, None)] + list(extra)
    cells = []
    for cfg, py in configs:
        (pb / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        if py is None:
            shutil.copy(PKG / "configs" / "qwen2.5-14b-int4.py",
                        pb / "configs" / f"{cfg['name']}.py")
        else:
            (pb / "configs" / f"{cfg['name']}.py").write_text(py)
        cell = f"{cfg['name']}.mini"
        (pb / "workloads" / f"{cell}.json").write_text(json.dumps(WORKLOAD))
        cells.append(cell)
    (pb / "traffic" / "mini.json").write_text(json.dumps(MIX))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": c["name"], "source": "test",
                        "file": f"perfbench/configs/{c['name']}.json",
                        "reduced": [], "why": "test"} for c, _ in configs]
    spec["workloads"] = [{"name": f"{c['name']}.mini", "config": c["name"],
                          "traffic": "mini", "chips": 1, "why": "test"}
                         for c, _ in configs]
    for m in spec["per_layer"]:
        m["workloads"] = cells
    spec["per_layer"].append({"name": "blocks.count", "unit": "blocks",
                              "better": "higher", "source": "program_span",
                              "layer": "pool", "moves": "serve_tok_s"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
