"""The CLIs' --tp / --dp on the CPU: each rank runs the CLI's `main` in a
gloo process group, as torchrun would start it (run_ranks), and the run
must give the outputs of the one-process run, at --dtype float32 (tiny
random geometries).

* tools/run_gsm8k.py --tp 2, both --tp-modes: the same answers and the
  same committed ids per question as --tp 1; rank 0 alone writes.
* tools/run_bench.py --tp 2, the speculative and the EAGLE engine: the
  same answers (turns) as --tp 1.
* tools/train_eagle.py --dp 2 (ZeRO moments) and --tp 2: the final
  checkpoint's head leaves within 1e-5 of the one-process run's, and the
  same step count.
"""
import json
import os

import pytest
import torch

import torch_parallel_ranks as R
from hsd_tpu_torch.parallel import run_ranks
from hsd_tpu_torch.tools import run_bench, run_gsm8k, train_eagle

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
F32 = ["--dtype", "float32", "--device", "cpu"]


def _json(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


GSM8K = ["--data", os.path.join(DATA, "gsm8k", "question.jsonl"),
         "--stride", "2", "--limit", "4", "--draft-geometry", "tiny",
         "--target-geometry", "tiny", "--gamma", "3", "--max-new-tokens",
         "10", "--prompt", "easy", "--tag", "t"] + F32


def _bench_args(engine):
    return ["--question-file", os.path.join(DATA, "qa", "question.jsonl"),
            "--bench-name", "qa", "--target-geometry", "tiny",
            "--draft-geometry", "tiny", "--gamma", "3", "--max-new-tokens",
            "8", "--warmup", "0", "--question-end", "2", "--engine", engine,
            "--total-tokens", "5", "--depth", "2", "--top-k", "2"] + F32


def _train_args(root):
    conv = root / "conv.jsonl"
    if not conv.exists():
        conv.write_text("\n".join(json.dumps({"id": i, "conversations": [
            {"from": "human", "value": f"question {i} about colors?"},
            {"from": "gpt", "value": f"answer {i}: blue and green."}]})
            for i in range(4)))
    return ["--data", str(conv), "--geometry", "tiny", "--batch-size", "2",
            "--buckets", "256", "--system", "hi", "--epochs", "1"] + F32


MODES, ENGINES, FLAGS = ("gspmd", "shardmap"), ("spec", "eagle"), ("dp", "tp")


@pytest.fixture(scope="module")
def parallel_runs(tmp_path_factory):
    """Every CLI's --tp / --dp run in one world of 2 (each rank runs the
    CLIs one after another, as torchrun would start each); the outputs
    under one directory per case."""
    root = tmp_path_factory.mktemp("par")
    calls = [("cli", ("hsd_tpu_torch.tools.run_gsm8k", GSM8K + [
        "--out-dir", str(root / f"gsm8k_{m}"), "--tp", "2", "--tp-mode",
        m])) for m in MODES]
    calls += [("cli", ("hsd_tpu_torch.tools.run_bench", _bench_args(e) + [
        "--out-dir", str(root / f"bench_{e}"), "--tp", "2"]))
        for e in ENGINES]
    calls += [("cli", ("hsd_tpu_torch.tools.train_eagle", _train_args(root)
                       + ["--ckpt-dir", str(root / f"train_{f}"), f"--{f}",
                          "2"])) for f in FLAGS]
    ranks = run_ranks(R.batch, 2, calls, device="cpu")
    assert ranks == [[0] * len(calls), [1] * len(calls)]
    return root


@pytest.mark.parametrize("mode", MODES)
def test_run_gsm8k_tp_matches_one_process(tmp_path, parallel_runs, mode):
    one = run_gsm8k.main(GSM8K + ["--out-dir", str(tmp_path / "one")])
    tp = parallel_runs / f"gsm8k_{mode}"
    with open(tmp_path / "one" / "counts_t.json") as f:
        want = json.load(f)
    with open(tp / "counts_t.json") as f:
        got = json.load(f)
    assert [c["ids"] for c in got] == [c["ids"] for c in want]
    assert [c["accepts"] for c in got] == [c["accepts"] for c in want]
    assert (tp / "answers_t.txt").read_text() == \
        (tmp_path / "one" / "answers_t.txt").read_text()
    assert one["questions"] == len(got)
    assert sorted(os.listdir(tp)) == ["answers_t.txt", "counts_t.json"]


@pytest.mark.parametrize("engine", ENGINES)
def test_run_bench_tp_matches_one_process(tmp_path, parallel_runs, engine):
    one = run_bench.main(_bench_args(engine)
                         + ["--out-dir", str(tmp_path / "one")])
    name = os.path.basename(one["answers"])
    want = _json(tmp_path / "one" / name)
    got = _json(parallel_runs / f"bench_{engine}" / name)
    assert [[c["turns"] for c in r["choices"]] for r in got] == \
        [[c["turns"] for c in r["choices"]] for r in want]


@pytest.mark.parametrize("flag", FLAGS)
def test_train_eagle_dp_tp_matches_one_process(tmp_path, parallel_runs,
                                               flag):
    train_eagle.main(_train_args(tmp_path)
                     + ["--ckpt-dir", str(tmp_path / "one")])
    par = parallel_runs / f"train_{flag}"
    assert sorted(os.listdir(par)) == \
        sorted(os.listdir(tmp_path / "one")) == ["state_2"]
    want = torch.load(tmp_path / "one" / "state_2" / "state.pt")
    got = torch.load(par / "state_2" / "state.pt")
    assert got["step"] == want["step"] == 2
    for k, v in want["params"].items():
        torch.testing.assert_close(got["params"][k], v, rtol=1e-5,
                                   atol=1e-5, msg=k)
    for i, st in want["opt"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(got["opt"]["state"][i][k], st[k],
                                       rtol=1e-4, atol=1e-9)
