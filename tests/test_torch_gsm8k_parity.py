"""End-to-end answer-law parity through the port's GSM8K harness (the
counterpart of `tests/test_gsm8k_parity.py`, at its bound): tokenwise and
HSD are both lossless, so their output distributions — and hence answer
distributions — agree up to sampling noise (the reference's Table-1
argument, README.md:90-119).

Setup: byte tokenizer + a tiny draft/target pair with real divergence
(the JAX file's draft, bridged, and the target = the draft with its
embedding x 1.3), 20 questions x 5 sampled generations, driven through
`hsd_tpu_torch.eval.gsm8k.run_eval` (prompt build -> bucket pad -> engine
-> artifacts -> counts). The per-output "answer" is the first digit byte
the model emits."""
import collections
import re

import jax
import torch

from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.eval.gsm8k import ByteTokenizer, EvalConfig, run_eval

torch.set_num_threads(2)

GEOM = dict(vocab_size=256, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2)
CFG = ModelConfig.tiny(**GEOM)

QUESTIONS = [
    {"question": f"A box holds {3 + i} pears and gains {2 + i} more. "
                 "How many pears are in the box?",
     "answer": f"#### {5 + 2 * i}"}
    for i in range(20)
]
SHOTS = "Question: 1 plus 1?\nLet's think step by step\nThe answer is 2\n"


def _first_digit(text: str):
    m = re.search(r"[0-9]", text)
    return m.group(0) if m else None


def _run(method, out_dir, copies=5):
    jd = j_init_params(JCfg.tiny(**GEOM), jax.random.PRNGKey(0))
    pd = bridge.params_from_jax(jd)
    pt = pd._replace(embed=pd.embed * 1.3)   # real draft/target divergence
    eng = EngineConfig(verifier=VerifierConfig(method=method, gamma=4),
                       max_new_tokens=48)
    rows = [q for q in QUESTIONS for _ in range(copies)]
    ev = EvalConfig(engine=eng, out_dir=str(out_dir), tag=method, seed=0)
    summary = run_eval(CFG, CFG, pd, pt, ByteTokenizer(), rows, SHOTS, ev,
                       device="cpu")
    return summary, summary["model_answers"]


def test_gsm8k_answer_distribution_parity(tmp_path):
    s_tok, a_tok = _run("tokenwise", tmp_path)
    s_hsd, a_hsd = _run("hsd", tmp_path)
    assert len(a_tok) == len(a_hsd) == 100

    def dist(answers):
        c = collections.Counter(_first_digit(a) for a in answers)
        n = sum(c.values())
        return {k: v / n for k, v in c.items()}

    d_t, d_h = dist(a_tok), dist(a_hsd)
    keys = set(d_t) | set(d_h)
    tv = 0.5 * sum(abs(d_t.get(k, 0) - d_h.get(k, 0)) for k in keys)
    # the JAX file's bound: TV between two 100-sample draws of an
    # ~11-category law concentrates well below it, while a genuinely
    # different law (e.g. greedy degenerate output) trips it
    assert tv < 0.25, (tv, d_t, d_h)
    # the digit channel must be non-degenerate
    assert sum(v for k, v in d_t.items() if k is not None) > 0.5
    # the counts channel flowed through the real artifact path, and the
    # expected qualitative BE ordering holds on the same runs
    assert s_tok["block_efficiency"] >= 1.0
    assert s_hsd["block_efficiency"] > s_tok["block_efficiency"] - 0.5
