"""The port's GSM8K harness, metrics and prompt library against the JAX
package (`hsd_tpu/eval/gsm8k.py`, `metrics.py`, `eagle_metrics.py`,
`prompt_library.py`); the counterparts of `tests/test_eval.py` and
`tests/test_prompt_library.py`.

* metrics / eagle_metrics: the same outputs on the same random telemetry.
* bucket_pad, build_prompt, qwen_chat_wrap, load_gsm8k_jsonl: equal.
* The prompt library: the port's build_library writes the JAX
  build_library's bytes, and the port's `lib_prompt/` is byte-equal to
  `hsd_tpu/eval/lib_prompt/`, every file and both .npy files.
* run_eval at temperature 0 on a bridged tiny byte-vocab pair: the same
  answers file and counts file, field for field, and the same summary,
  apart from the fields that carry wall time.
"""
import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch

from hsd_tpu.config import EngineConfig as JEng
from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.config import VerifierConfig as JVer
from hsd_tpu.eval import eagle_metrics as jem
from hsd_tpu.eval import gsm8k as jg
from hsd_tpu.eval import metrics as jm
from hsd_tpu.eval import prompt_library as jpl
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.eval import eagle_metrics as tem
from hsd_tpu_torch.eval import gsm8k as tg
from hsd_tpu_torch.eval import metrics as tm
from hsd_tpu_torch.eval import prompt_library as tpl
from hsd_tpu_torch.eval.gsm8k import (ByteTokenizer, EvalConfig, bucket_pad,
                                      default_prompt_path, run_eval)
from hsd_tpu_torch.eval.metrics import (accuracy, block_efficiency,
                                        decoding_speed, extract_answer)
from hsd_tpu_torch.eval.metrics import test_answer as check_answer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JLIB = os.path.join(ROOT, "hsd_tpu", "eval", "lib_prompt")
TLIB = os.path.join(ROOT, "hsd_tpu_torch", "eval", "lib_prompt")
# fields that carry wall time: masked in every parity check, nothing else
TIME_FIELDS = ("time_s", "time")


# ---------------------------------------------------------------------------
# metrics (tests/test_eval.py's cases, then equal outputs to JAX's)
# ---------------------------------------------------------------------------

def test_answer_extraction():
    assert extract_answer("the answer is 42.") == "42"
    assert extract_answer("so 3.5 plus 2 = 5.5") == "5.5"
    assert extract_answer("no numbers here") is None
    assert check_answer("A_model: ... the result is 18", "A: #### 18")
    assert not check_answer("result 17", "#### 18")
    assert accuracy(["x 18", "y 3"], ["#### 18", "#### 4"]) == 0.5


def test_block_efficiency_full_gamma_filter():
    accepts = [[9, 4, 9], [2]]
    dls = [[10, 3, 10], [10]]
    assert abs(block_efficiency(accepts, dls, 10) - 23 / 3) < 1e-9


def test_decoding_speed_time_scaling():
    ds = decoding_speed([[9, 4]], [[10, 10]], [2.0], 10)
    assert abs(ds - (10 + 5) / 2.0) < 1e-9


def _telemetry(seed, gamma=7, questions=6):
    rng = np.random.default_rng(seed)
    acc = [rng.integers(0, gamma + 1, rng.integers(1, 12)).tolist()
           for _ in range(questions)]
    dls = [[int(gamma if rng.random() < 0.8 else rng.integers(1, gamma))
            for _ in a] for a in acc]
    plens = [rng.integers(1, gamma + 2, len(a)).tolist() for a in acc]
    times = rng.uniform(0.1, 2.0, questions).tolist()
    return acc, dls, plens, times


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_jax(seed):
    acc, dls, _, times = _telemetry(seed)
    counts = [dict(accepts=a, draft_lens=d, time_s=t)
              for a, d, t in zip(acc, dls, times)]
    assert tm.summarize(counts, 7) == jm.summarize(counts, 7)
    assert tm.block_efficiency(acc, dls, 7) == jm.block_efficiency(acc, dls, 7)
    assert (tm.decoding_speed(acc, dls, times, 7)
            == jm.decoding_speed(acc, dls, times, 7))
    texts = ["so 3 + 4 = 7", "none", "The answer is 12.5", "#### 8"]
    assert [tm.extract_answer(t) for t in texts] == \
        [jm.extract_answer(t) for t in texts]
    assert tm.accuracy(texts, texts[::-1]) == jm.accuracy(texts, texts[::-1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eagle_metrics_equal_jax(tmp_path, seed):
    acc, dls, plens, times = _telemetry(seed)
    for name, mod in (("j", jem), ("t", tem)):
        with open(tmp_path / f"{name}_info.jsonl", "w") as f:
            for a, d, p, t in zip(acc, dls, plens, times):
                mod.write_info_row(f, a, d, t, stage_times={"x_time": [[t]]},
                                   path_lens=p)
    assert filecmp.cmp(tmp_path / "j_info.jsonl", tmp_path / "t_info.jsonl",
                       shallow=False)
    path = str(tmp_path / "t_info.jsonl")
    assert tem.evaluate_info_file(path) == jem.evaluate_info_file(path)
    rows = [json.loads(l) for l in open(path)]
    np.testing.assert_array_equal(tem.evaluate_alpha_rows(rows),
                                  jem.evaluate_alpha_rows(rows))
    for a, p in zip(acc, plens):
        for x, y in zip(tem.alpha_from_blocks(a, p),
                        jem.alpha_from_blocks(a, p)):
            np.testing.assert_array_equal(x, y)
    ans = [{"choices": [{"new_tokens": [len(a)], "wall_time": [t]}]}
           for a, t in zip(acc, times)]
    assert tem.speed_ratio(ans, ans[::-1]) == jem.speed_ratio(ans, ans[::-1])
    assert tem.evaluate_info_file(str(tmp_path / "missing.jsonl")) is None


def test_plot_summary_without_matplotlib_returns_none_or_path(tmp_path):
    s = {"hsd": {"block_efficiency": 4.0, "decoding_speed": 10.0}}
    out = tm.plot_summary(s, str(tmp_path / "p.png"))
    assert out is None or os.path.exists(out)


# ---------------------------------------------------------------------------
# prompt building and the prompt library
# ---------------------------------------------------------------------------

def test_bucket_pad():
    ids = list(range(100))
    padded, n = bucket_pad(ids)
    assert padded.shape[0] == 512 and n == 100
    assert padded[-1] == 99 and padded[0] == 0


@pytest.mark.parametrize("n", [0, 1, 511, 512, 513, 1536, 2048, 2049, 3000])
def test_bucket_pad_equal_jax(n):
    ids = list(range(7, 7 + n))
    tp, tn = tg.bucket_pad(ids)
    jp, jn = jg.bucket_pad(ids)
    assert tn == jn and tp.dtype == jp.dtype
    np.testing.assert_array_equal(tp, jp)


def test_prompts_equal_jax(tmp_path):
    shots = open(os.path.join(JLIB, "prompt_original.txt")).read()
    rows = [json.loads(l) for l in open(os.path.join(
        ROOT, "data", "gsm8k", "question.jsonl"))]
    for r in rows:
        assert tg.build_prompt(r["question"], shots) == \
            jg.build_prompt(r["question"], shots)
        assert tg.qwen_chat_wrap(r["question"]) == \
            jg.qwen_chat_wrap(r["question"])
        text = tg.build_prompt(r["question"], shots)
        assert ByteTokenizer().encode(text) == jg.ByteTokenizer().encode(text)
        # a prompt of the original library lands in bucket 2048, truncated
        assert tg.bucket_pad(ByteTokenizer().encode(text))[1] == 2048
    for stride in (1, 2, 5):
        assert tg.load_gsm8k_jsonl(os.path.join(
            ROOT, "data", "gsm8k", "question.jsonl"), stride=stride) == \
            jg.load_gsm8k_jsonl(os.path.join(
                ROOT, "data", "gsm8k", "question.jsonl"), stride=stride)
    ids = list(range(300)) + [1000, 70000]
    assert ByteTokenizer().decode(ids) == jg.ByteTokenizer().decode(ids)


def test_library_byte_equal_jax(tmp_path):
    """The port's build_library writes the JAX build_library's bytes, and
    the port's packaged lib_prompt/ is byte-equal to the JAX package's."""
    tn = tpl.build_library(str(tmp_path / "t"))
    jn = jpl.build_library(str(tmp_path / "j"))
    assert tn == jn and len(tn) == 28
    for name in tn:
        assert filecmp.cmp(tmp_path / "t" / name, tmp_path / "j" / name,
                           shallow=False), name
        assert filecmp.cmp(tmp_path / "t" / name, os.path.join(TLIB, name),
                           shallow=False), name
    shipped = sorted(os.listdir(JLIB))
    assert sorted(os.listdir(TLIB)) == shipped and len(shipped) == 29
    for name in shipped:
        assert filecmp.cmp(os.path.join(TLIB, name), os.path.join(JLIB, name),
                           shallow=False), name


def test_default_prompt_library():
    """The packaged library resolves in the port; each shot carries a
    final 'The answer is N' line the metrics regex extracts."""
    path = default_prompt_path()
    assert path.startswith(TLIB)
    text = open(path).read()
    shots = [s for s in text.split("\n\n") if s.strip()]
    assert len(shots) == 8
    for s in shots:
        assert s.startswith("Question: ")
        assert "Let's think step by step" in s
        assert extract_answer(s.rsplit("The answer is", 1)[1]) is not None
    assert default_prompt_path("hardest").endswith("prompt_hardest.txt")
    with pytest.raises(FileNotFoundError) as e:
        default_prompt_path("nope")
    assert "have" in str(e.value)


def test_pool_and_transforms_equal_jax():
    tp, jp = tpl.build_pool(), jpl.build_pool()
    assert list(tp) == list(jp)
    for style in ("original", "explicit", "exclamation", "semicolon",
                  "no_break", "ao"):
        for k in tp:
            assert tpl.render(tp[k], style) == jpl.render(jp[k], style)


# ---------------------------------------------------------------------------
# run_eval end to end against the JAX harness
# ---------------------------------------------------------------------------

JCFG = JCfg.tiny(vocab_size=256)
TCFG = ModelConfig.tiny(vocab_size=256)


def _pair():
    jd = j_init_params(JCFG, jax.random.PRNGKey(0))
    jt = j_init_params(JCFG, jax.random.PRNGKey(1))
    return jd, jt, bridge.params_from_jax(jd), bridge.params_from_jax(jt)


def _questions(tmp_path, n=10):
    data = tmp_path / "test.jsonl"
    rows = [{"question": f"What is {i} + {i}?", "answer": f"#### {2*i}"}
            for i in range(n)]
    data.write_text("\n".join(json.dumps(r) for r in rows))
    return str(data)


def _masked(counts):
    return [{k: v for k, v in c.items() if k not in TIME_FIELDS}
            for c in counts]


@pytest.mark.parametrize("method", ["hsd", "tokenwise"])
def test_run_eval_equals_jax_at_temperature_0(tmp_path, method):
    """The same questions, prompt and bridged weights at temperature 0:
    the same answers file, the same counts (every alias key), the same
    summary, apart from wall-time fields."""
    jd, jt, td, tt = _pair()
    qs = tg.load_gsm8k_jsonl(_questions(tmp_path), stride=3)
    shots = "Question: 1 plus 1?\nLet's think step by step\nThe answer is 2\n"
    v = dict(method=method, gamma=4, num_drafts=1)
    jsum = jg.run_eval(JCFG, JCFG, jd, jt, jg.ByteTokenizer(), qs, shots,
                       jg.EvalConfig(engine=JEng(
                           verifier=JVer(**v), max_new_tokens=16,
                           temperature=0.0),
                           out_dir=str(tmp_path / "j"), tag="x"))
    tsum = run_eval(TCFG, TCFG, td, tt, ByteTokenizer(), qs, shots,
                    EvalConfig(engine=EngineConfig(
                        verifier=VerifierConfig(**v), max_new_tokens=16,
                        temperature=0.0),
                        out_dir=str(tmp_path / "t"), tag="x"),
                    device="cpu")
    assert filecmp.cmp(tmp_path / "j" / "answers_x.txt",
                       tmp_path / "t" / "answers_x.txt", shallow=False)
    jc = json.loads((tmp_path / "j" / "counts_x.json").read_text())
    tc = json.loads((tmp_path / "t" / "counts_x.json").read_text())
    assert len(tc) == len(qs) == 4
    assert set(tc[0]) == set(jc[0])
    assert _masked(tc) == _masked(jc)
    for s in (jsum, tsum):
        s.pop("decoding_speed")
        s["artifacts"] = {k: os.path.basename(p)
                          for k, p in s["artifacts"].items()}
    assert tsum == jsum


def test_gsm8k_end_to_end_smoke(tmp_path):
    """tests/test_eval.py's smoke on the port: sampled, two questions."""
    qs = tg.load_gsm8k_jsonl(_questions(tmp_path), stride=5)
    assert len(qs) == 2
    _, _, td, tt = _pair()
    ev = EvalConfig(engine=EngineConfig(
        verifier=VerifierConfig(method="hsd", gamma=4, num_drafts=1),
        max_new_tokens=16), out_dir=str(tmp_path / "out"), tag="smoke")
    summary = run_eval(TCFG, TCFG, td, tt, ByteTokenizer(), qs,
                       "Q: 1+1?\nA: 2", ev, device="cpu")
    assert summary["questions"] == 2
    assert summary["block_efficiency"] > 0
    assert (tmp_path / "out" / "answers_smoke.txt").exists()
    counts = json.loads((tmp_path / "out" / "counts_smoke.json").read_text())
    assert len(counts) == 2 and "accepts" in counts[0]
    assert "hist_lengths" not in counts[0]     # single-pass: rounds is None
    # the summary's BE is the mean of accepts + 1 over the counts file
    acc = [a for c in counts for a in c["accepts"]]
    assert abs(summary["block_efficiency"] - np.mean(acc) - 1) < 1e-12
    # seeded: question qi's generator is fold_seed(seed, qi)
    again = run_eval(TCFG, TCFG, td, tt, ByteTokenizer(), qs,
                     "Q: 1+1?\nA: 2", ev, device="cpu")
    assert again["model_answers"] == summary["model_answers"]


def test_run_eval_needs_a_device_or_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_eval(TCFG, TCFG, None, None, ByteTokenizer(), [], "",
                 EvalConfig(engine=EngineConfig()))


def test_alpha_aggregator_roundtrip(tmp_path):
    """tests/test_eval_fixtures.py's alpha case on the port: engine
    telemetry through write_info_row, aggregated by evaluate_alpha_rows,
    against the hand-computed per-position rates."""
    blocks = [(3, 6), (0, 6), (5, 6), (2, 4), (1, 2)]
    acc = [a for a, _ in blocks]
    pl = [p for _, p in blocks]
    a, n = tem.alpha_from_blocks(acc, pl, max_pos=5)
    want_num = np.zeros(5, int)
    want_acc = np.zeros(5, int)
    for av, pv in blocks:
        for i in range(min(min(av + 1, pv - 1), 5)):
            want_num[i] += 1
            want_acc[i] += int(i < av)
    np.testing.assert_array_equal(n, want_num)
    np.testing.assert_array_equal(a, want_acc)
    fp = tmp_path / "x_info.jsonl"
    with open(fp, "w") as f:
        tem.write_info_row(f, acc, [5] * len(acc), 1.0, path_lens=pl)
        tem.write_info_row(f, acc, [5] * len(acc), 1.0, path_lens=pl)
    rows = [json.loads(l) for l in open(fp)]
    np.testing.assert_allclose(
        tem.evaluate_alpha_rows(rows),
        np.where(want_num > 0, want_acc / np.maximum(want_num, 1), 0))


def test_engine_path_lens_telemetry():
    """The port's EAGLE engine records the best path's valid length per
    block, bounded by the trie geometry and >= accept_length + 1 (the
    telemetry run_multibench turns into alpha)."""
    from hsd_tpu_torch.engine.eagle_engine import make_eagle_generate
    from hsd_tpu_torch.models import init_params
    from hsd_tpu_torch.models.eagle import EagleConfig, init_eagle_params

    tcfg = ModelConfig.tiny(vocab_size=64, hidden_size=32,
                            intermediate_size=64, num_layers=4, num_heads=4,
                            num_kv_heads=2)
    ecfg = EagleConfig(hidden_size=32, target_hidden_size=32, num_heads=4,
                       num_kv_heads=2, vocab_size=64, draft_vocab_size=64,
                       intermediate_size=64, top_k=4, depth=3,
                       total_tokens=11, dtype=torch.float32,
                       rope_theta=10000.0)
    pt = init_params(tcfg, seed=0, device="cpu")
    pe = init_eagle_params(ecfg, seed=1, device="cpu")
    gen = make_eagle_generate(tcfg, ecfg, EngineConfig(max_new_tokens=12,
                                                       temperature=1.0),
                              mode="hsd")
    res = gen(pt, pe, (torch.arange(9) % 50) + 1, 9,
              torch.Generator().manual_seed(3))
    pls = res.path_lens[:res.blocks].numpy()
    accs = res.accepts[:res.blocks].numpy()
    assert ((pls >= 1) & (pls <= ecfg.depth + 2)).all(), pls
    assert (accs + 1 <= pls).all(), (accs, pls)
