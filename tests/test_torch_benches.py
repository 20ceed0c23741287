"""The port's multi-bench loaders and drivers (`eval/benches.py`,
`eval/bench_runner.py`) and its two eval CLIs (`tools/run_gsm8k.py`,
`tools/run_bench.py`) against the JAX package; the counterparts of
`tests/test_benches.py` and `tests/test_bench_runner.py`.

* Every bench loader over the shipped `data/*/question.jsonl`, and over
  the formats of the JAX tests' fixtures: the same rows.
* run_bench and run_multibench at temperature 0 on a bridged tiny pair:
  the same answers and `_info.jsonl` rows, field for field, apart from the
  masked fields (`answer_id`, a uuid; `tstamp`; every time field).
* The JAX tests' cases of the drivers (artifact shapes, multi-turn,
  choices, determinism, reorg) on the port, and both CLIs end to end on
  the CPU at a tiny size.
"""
import json
import os

import jax
import pytest
import torch

from hsd_tpu.config import EngineConfig as JEng
from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.config import VerifierConfig as JVer
from hsd_tpu.engine import make_generate as j_make_generate
from hsd_tpu.eval import bench_runner as jbr
from hsd_tpu.eval import benches as jb
from hsd_tpu.eval.gsm8k import ByteTokenizer as JByteTokenizer
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine import make_generate
from hsd_tpu_torch.eval import bench_runner as tbr
from hsd_tpu_torch.eval.benches import (ChatTemplate, get_system_prompt,
                                        load_bench_questions,
                                        load_cnndailymail_questions,
                                        load_flores200_questions,
                                        load_humaneval_questions,
                                        reorg_answer_file, run_multibench,
                                        strip_output)
from hsd_tpu_torch.eval.eagle_metrics import evaluate_info_file
from hsd_tpu_torch.eval.gsm8k import ByteTokenizer
from hsd_tpu_torch.tools import run_bench as cli_bench
from hsd_tpu_torch.tools import run_gsm8k as cli_gsm8k

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
BENCHES = ["mt_bench", "alpaca", "qa", "sum", "humaneval", "gsm8k",
           "flores200", "cnndailymail"]
# fields that differ run to run: masked in every parity check, nothing else
MASKED = {"answer_id", "tstamp", "wall_time", "generate_time",
          "tokenizer_time", "tokenizer_decode_time"}


def _write_jsonl(path, rows):
    path.write_text("\n".join(json.dumps(r) for r in rows))
    return str(path)


def _mask(obj):
    if isinstance(obj, dict):
        return {k: _mask(v) for k, v in obj.items() if k not in MASKED}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _rows(path):
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]


# ---------------------------------------------------------------------------
# loaders and templates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bench", BENCHES)
def test_shipped_fixture_loads_equal_jax(bench):
    path = os.path.join(DATA, bench, "question.jsonl")
    rows = load_bench_questions(bench, path)
    assert rows == jb.load_bench_questions(bench, path)
    assert len(rows) >= 3
    for r in rows:
        assert "question_id" in r and "turns" in r
        assert all(isinstance(t, str) and t for t in r["turns"])
    if bench == "mt_bench":
        assert all(len(r["turns"]) == 2 for r in rows)
    for kw in (dict(begin=1, end=3), dict(shard="1/2")):
        assert load_bench_questions(bench, path, **kw) == \
            jb.load_bench_questions(bench, path, **kw)
    assert tbr.load_questions(path, limit=2, shard="0/1") == \
        jbr.load_questions(path, limit=2, shard="0/1")
    for r in tbr.load_questions(path):
        try:
            want = jbr.extract_question(r)
        except KeyError:
            with pytest.raises(KeyError):
                tbr.extract_question(r)
        else:
            assert tbr.extract_question(r) == want


def test_system_prompts_and_templates_equal_jax():
    for b in BENCHES + ["other"]:
        assert get_system_prompt(b) == jb.get_system_prompt(b)
    assert "translation" in get_system_prompt("flores200")
    assert "summar" in get_system_prompt("cnndailymail")
    msgs = [{"role": "system", "content": "S"},
            {"role": "user", "content": "U1"},
            {"role": "assistant", "content": "A1"},
            {"role": "user", "content": "U2"}]
    for style in ("qwen", "llama3", "plain"):
        t, j = ChatTemplate(style), jb.ChatTemplate(style)
        assert t.render(msgs) == j.render(msgs)
        assert t.stop_strings == j.stop_strings
        for text in ("hello<|im_end|>\njunk", "  plain  ",
                     "<|begin_of_text|>x<|eot_id|>y"):
            assert strip_output(text, t) == jb.strip_output(text, j)
    q = ChatTemplate("qwen").render(msgs)
    assert q.count("<|im_start|>") == 5 and q.endswith("assistant\n")


def test_loader_formats_equal_jax(tmp_path):
    """The JAX tests' fixture formats: humaneval, truncated cnndm, the
    flores filter, bench routing with begin/end and shards."""
    he = _write_jsonl(tmp_path / "he.jsonl", [
        {"task_id": "HumanEval/0", "prompt": "def f():\n",
         "canonical_solution": "    return 1\n"}])
    qs = load_humaneval_questions(he)
    assert qs == jb.load_humaneval_questions(he)
    assert qs[0]["turns"][0].startswith("Complete the code I provided.\n")
    cn = _write_jsonl(tmp_path / "cn.jsonl", [
        {"article": "x" * 50, "highlights": "h"},
        {"article": "y" * 9000, "highlights": "h2"}])
    qs = load_cnndailymail_questions(cn, max_article_chars=100)
    assert qs == jb.load_cnndailymail_questions(cn, max_article_chars=100)
    assert "y" * 100 + "..." in qs[1]["turns"][0]
    assert "y" * 101 not in qs[1]["turns"][0]
    fl = _write_jsonl(tmp_path / "fl.jsonl", [
        {"source": "hello", "target": "bonjour",
         "source_lang": "eng_Latn", "target_lang": "fra_Latn"},
        {"source": "hallo", "target": "x",
         "source_lang": "deu_Latn", "target_lang": "fra_Latn"}])
    qs = load_flores200_questions(fl)
    assert qs == jb.load_flores200_questions(fl) and len(qs) == 1
    assert "Translate the following Eng text to Fra" in qs[0]["turns"][0]
    mt = _write_jsonl(tmp_path / "question.jsonl", [
        {"question_id": i, "turns": [f"q{i}", f"follow{i}"]}
        for i in range(6)])
    assert [q["question_id"] for q in load_bench_questions(
        "mt_bench", mt, begin=1, end=5)] == [1, 2, 3, 4]
    assert [q["question_id"] for q in load_bench_questions(
        "mt_bench", mt, shard="1/2")] == [1, 3, 5]
    for k in ("turns", "question", "instruction", "article"):
        row = {k: ["hi"] if k == "turns" else "hi"}
        assert tbr.extract_question(row) == jbr.extract_question(row) == "hi"


def test_reorg_answer_file(tmp_path):
    p = tmp_path / "ans.jsonl"
    _write_jsonl(p, [{"question_id": 3, "v": "old"},
                     {"question_id": 1, "v": "a"},
                     {"question_id": 3, "v": "new"}])
    reorg_answer_file(str(p))
    out = _rows(p)
    assert [r["question_id"] for r in out] == [1, 3]
    assert out[1]["v"] == "new"  # dedup keeps the last


# ---------------------------------------------------------------------------
# the drivers against JAX's at temperature 0
# ---------------------------------------------------------------------------

JCFG = JCfg.tiny(vocab_size=256)
TCFG = ModelConfig.tiny(vocab_size=256)


def _gens(method="hsd", gamma=4, max_new=8, temp=0.0):
    jd = j_init_params(JCFG, jax.random.PRNGKey(0))
    jt = j_init_params(JCFG, jax.random.PRNGKey(1))
    td, tt = bridge.params_from_jax(jd), bridge.params_from_jax(jt)
    v = dict(method=method, gamma=gamma)
    jg = j_make_generate(JCFG, JCFG, JEng(verifier=JVer(**v),
                                          max_new_tokens=max_new,
                                          temperature=temp))
    tg = make_generate(TCFG, TCFG, EngineConfig(
        verifier=VerifierConfig(**v), max_new_tokens=max_new,
        temperature=temp))
    return (lambda p, n, k: jg(jd, jt, p, n, k),
            lambda p, n, g: tg(td, tt, p, n, g))


def test_run_bench_equals_jax(tmp_path):
    qs = [{"question_id": i, "turns": [f"Say hello number {i}"]}
          for i in range(3)] + [{"question": "What is 2 + 2?"}]
    jgen, tgen = _gens(max_new=12)
    jout = jbr.run_bench(qs, JByteTokenizer(), lambda s: s + "\n", jgen,
                         str(tmp_path / "j"), "b", warmup=1)
    tout = tbr.run_bench(qs, ByteTokenizer(), lambda s: s + "\n", tgen,
                         str(tmp_path / "t"), "b", warmup=1, device="cpu")
    assert tout["questions"] == jout["questions"] == 4
    assert _rows(tout["answers"]) == _rows(jout["answers"])
    assert _mask(_rows(tout["info"])) == _mask(_rows(jout["info"]))
    be = lambda out: {k: v for k, v in evaluate_info_file(
        out["info"], gamma=4).items() if k in ("block_efficiency",
                                               "questions")}
    assert be(tout) == be(jout)


def test_run_multibench_equals_jax(tmp_path):
    """Two questions of two turns, two choices each, the qwen template and
    mt_bench's system prompt: the same answers and info rows as JAX's
    apart from the masked fields; every field the JAX rows carry."""
    rows = [{"question_id": 10 + i, "turns": [f"Say {i}", "More?"]}
            for i in range(2)]
    jgen, tgen = _gens()
    kw = dict(bench_name="mt_bench", num_choices=2, warmup=1)
    jout = jb.run_multibench(rows, JByteTokenizer(), jgen,
                             str(tmp_path / "j"), "mt", **kw)
    tout = run_multibench(rows, ByteTokenizer(), tgen, str(tmp_path / "t"),
                          "mt", device="cpu", **kw)
    ja, ta = _rows(jout["answers"]), _rows(tout["answers"])
    assert [set(r) for r in ta] == [set(r) for r in ja]
    assert _mask(ta) == _mask(ja)
    ji, ti = _rows(jout["info"]), _rows(tout["info"])
    assert [set(r) for r in ti] == [set(r) for r in ji]
    assert _mask(ti) == _mask(ji)
    assert tout["new_tokens"] == jout["new_tokens"]
    assert len(ta[0]["answer_id"]) == 22


def test_run_multibench_artifacts(tmp_path):
    """tests/test_benches.py's driver case on the port: sampled, two
    choices, the plain template; reference shapes and determinism."""
    rows = [{"question_id": 10 + i, "turns": [f"Say {i}", "More?"]}
            for i in range(2)]
    _, tgen = _gens(temp=1.0)
    out = run_multibench(rows, ByteTokenizer(), tgen, str(tmp_path), "mt",
                         bench_name="mt_bench", num_choices=2, warmup=1,
                         template=ChatTemplate("plain"), device="cpu")
    answers = _rows(out["answers"])
    assert len(answers) == 2
    a = answers[0]
    assert a["question_id"] == 10 and len(a["choices"]) == 2
    c = a["choices"][0]
    assert len(c["turns"]) == 2 == len(c["new_tokens"]) == len(c["wall_time"])
    assert a["answer_id"] and a["model_id"] == "hsd_tpu"
    infos = _rows(out["info"])
    assert len(infos) == 4
    assert len(infos[0]["accept_length"]) == 2
    assert isinstance(infos[0]["accept_length"][0], list)
    m = evaluate_info_file(out["info"], gamma=4)
    assert m["questions"] == 4 and m["block_efficiency"] > 0
    out2 = run_multibench(rows, ByteTokenizer(), tgen, str(tmp_path), "mt2",
                          bench_name="mt_bench", num_choices=2, warmup=0,
                          template=ChatTemplate("plain"), device="cpu")
    a2 = _rows(out2["answers"])
    assert [c["turns"] for c in a2[0]["choices"]] == \
        [c["turns"] for c in answers[0]["choices"]]


# ---------------------------------------------------------------------------
# the CLIs on the CPU
# ---------------------------------------------------------------------------

def test_run_gsm8k_cli(tmp_path, capsys):
    summary = cli_gsm8k.main([
        "--data", os.path.join(DATA, "gsm8k", "question.jsonl"),
        "--stride", "2", "--draft-geometry", "tiny", "--target-geometry",
        "tiny", "--gamma", "4", "--max-new-tokens", "12", "--device", "cpu",
        "--out-dir", str(tmp_path), "--tag", "cli", "--prompt", "easy"])
    assert summary["questions"] == 3
    assert summary["config"]["method"] == "hsd"
    assert os.path.exists(tmp_path / "answers_cli.txt")
    assert json.loads(capsys.readouterr().out)["questions"] == 3
    with pytest.raises(NotImplementedError, match="1.10"):
        cli_gsm8k.main(["--data", "x", "--tp", "2"])


@pytest.mark.parametrize("engine", ["spec", "eagle"])
def test_run_bench_cli(tmp_path, engine):
    args = ["--question-file", os.path.join(DATA, "qa", "question.jsonl"),
            "--bench-name", "qa", "--target-geometry", "tiny",
            "--draft-geometry", "tiny", "--gamma", "3",
            "--max-new-tokens", "8", "--warmup", "1", "--device", "cpu",
            "--out-dir", str(tmp_path), "--question-end", "2",
            "--engine", engine, "--total-tokens", "5", "--depth", "2",
            "--top-k", "2", "--shard", "0/1"]
    out = cli_bench.main(args)
    assert out["questions"] == 2 and out["new_tokens"] > 0
    assert out["metrics"]["questions"] == 2
    assert os.path.basename(out["answers"]) == "qa_hsd_tpu_shard0of1.jsonl"
    assert cli_bench.main(["--question-file", "x", "--reorg",
                           out["answers"]]) is None
    assert [r["question_id"] for r in _rows(out["answers"])] == [
        q["question_id"] for q in load_bench_questions(
            "qa", os.path.join(DATA, "qa", "question.jsonl"), end=2)]
