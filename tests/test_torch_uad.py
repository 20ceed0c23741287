"""The port's UAD (different-tokenizer drafting, hsd_tpu_torch/engine/uad.py)
on the CPU, against the JAX package's `hsd_tpu/engine/uad.py`.

* The tokenizer-side functions (align_suffix, longest_diag_run,
  split_new_tokens) on tests/test_uad.py's cases and on 300 random pairs
  of small-alphabet windows: equal results.
* Both drafters on the toy tokenizers of tests/test_uad.py (greedy BPE
  with merges; one char a token, which is also its byte-level draft
  side): the same proposals, round after round, and for UadTokenDrafter
  the same draft-id history.
* make_uad_generate at temperature 0 on a bridged tiny target (float32):
  the port's stream equals the JAX package's and the target's AR stream,
  with both drafters; sampled, every token in the vocabulary, within the
  budget.
"""
import jax
import numpy as np
import pytest
import torch

from hsd_tpu.config import EngineConfig as JEng
from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.config import VerifierConfig as JVer
from hsd_tpu.engine import uad as juad
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine import make_autoregressive
from hsd_tpu_torch.engine import uad as tuad

torch.set_num_threads(2)


class CharTok:
    """One char a token (ids 0-25)."""

    def decode(self, ids):
        return "".join(chr((int(i) % 26) + 97) for i in ids)

    def encode(self, s):
        return [ord(c) - 97 for c in s if "a" <= c <= "z"]


class BpeTok:
    """Greedy BPE: single chars a-z (0-25) plus two merges."""
    MERGES = {"ab": 26, "cd": 27}

    def decode(self, ids):
        inv = {v: k for k, v in self.MERGES.items()}
        return "".join(inv.get(int(i), chr((int(i) % 26) + 97)) for i in ids)

    def encode(self, s):
        out, i = [], 0
        while i < len(s):
            if s[i:i + 2] in self.MERGES:
                out.append(self.MERGES[s[i:i + 2]])
                i += 2
            else:
                out.append(ord(s[i]) - 97)
                i += 1
        return out


@pytest.mark.parametrize("old,new", [
    ([1, 2, 3], [1, 2, 4]), ([1], [2]), ([1, 2], [1, 2, 9]), ([], [1]),
    ([23, 0, 1, 24, 25], [23, 26, 24, 25]), ([1, 2, 3], [1, 2, 3]),
    ([23, 24, 0], [23, 24, 26, 2, 3])])
def test_host_functions_match_jax_cases(old, new):
    assert tuad.align_suffix(old, new) == juad.align_suffix(old, new)
    assert tuad.longest_diag_run(old, new) == juad.longest_diag_run(old, new)
    assert tuad.split_new_tokens(old, new) == juad.split_new_tokens(old, new)


def test_host_functions_match_jax_random():
    rng = np.random.default_rng(0)
    for _ in range(300):
        a = rng.integers(0, 4, int(rng.integers(0, 12))).tolist()
        b = rng.integers(0, 4, int(rng.integers(0, 12))).tolist()
        if rng.random() < 0.5 and a:              # plant a shared run
            k = int(rng.integers(1, len(a) + 1))
            b = b[:3] + a[-k:] + b[3:]
        assert tuad.align_suffix(a, b) == juad.align_suffix(a, b)
        assert tuad.longest_diag_run(a, b) == juad.longest_diag_run(a, b)
        assert tuad.split_new_tokens(a, b) == juad.split_new_tokens(a, b)


def _rounds(make, committed, n_rounds=6, gamma=3, accept=(1, 0, 3, 2)):
    """Drive a drafter pair through rounds: each accepts a few proposals
    and appends one token of its own, as a verify block would."""
    jd, td = make(juad), make(tuad)
    out = []
    for r in range(n_rounds):
        pj, pt = jd.propose(committed, gamma), td.propose(committed, gamma)
        assert pt == pj, (r, pj, pt)
        out.append(pt)
        if hasattr(jd, "draft_ids"):
            assert td.draft_ids == jd.draft_ids
            assert td.prev_target_len == jd.prev_target_len
        committed = committed + pt[:accept[r % len(accept)]] + [r % 26]
    return out


@pytest.mark.parametrize("text", ["xabyz", "thecatsat", "abcdabcdab"])
def test_text_drafter_matches_jax(text):
    tok = BpeTok()

    def make(m):
        return m.UadDrafter(tok, tok, lambda t, n: t[-3:][:n],
                            chars_per_token=1, lookbehind=4)
    props = _rounds(make, tok.encode(text))
    assert any(props)


@pytest.mark.parametrize("text", ["xyzqr", "xabyz", "cdcdabq"])
def test_token_drafter_matches_jax(text):
    ttok, dtok = BpeTok(), CharTok()

    def make(m):
        return m.UadTokenDrafter(
            ttok, dtok, lambda ids, n: dtok.encode(dtok.decode(ids)[-3:][:n]),
            tokens_per_target_token=1, target_lookbehind=3,
            assistant_lookbehind=4)
    props = _rounds(make, ttok.encode(text), n_rounds=8)
    assert any(props)


JCFG = JCfg.tiny(vocab_size=26, eos_token_id=25)
JPT = j_init_params(JCFG, jax.random.PRNGKey(1))
TCFG = ModelConfig.tiny(vocab_size=26, eos_token_id=25)


def _drafters():
    tok = CharTok()
    return [
        ("text", lambda m: m.UadDrafter(tok, tok, lambda t, n: t[-3:][:n],
                                        chars_per_token=1)),
        ("token", lambda m: m.UadTokenDrafter(
            tok, tok, lambda ids, n: list(ids[-3:])[:n],
            tokens_per_target_token=1))]


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("gamma", [1, 3])
def test_greedy_stream_equals_jax_and_ar(which, gamma):
    name, make = _drafters()[which]
    tok = CharTok()
    prompt = tok.encode("abcabdabcab")
    jeng = JEng(verifier=JVer(method="tokenwise", gamma=gamma),
                max_new_tokens=20, temperature=0.0)
    teng = EngineConfig(verifier=VerifierConfig(method="tokenwise",
                                                gamma=gamma),
                        max_new_tokens=20, temperature=0.0)
    want = juad.make_uad_generate(JCFG, jeng, make(juad))(
        JPT, prompt, jax.random.PRNGKey(2))
    tp = bridge.params_from_jax(JPT)
    got = tuad.make_uad_generate(TCFG, teng, make(tuad), device="cpu")(
        tp, prompt, None)
    assert got == want, name
    toks, length = make_autoregressive(TCFG, teng)(
        tp, torch.tensor(prompt), len(prompt), None)
    ar = toks[len(prompt):length].tolist()
    assert got == ar[:len(got)] and (len(got) == 20 or got[-1] == 25)


def test_sampled_stream_in_range():
    name, make = _drafters()[0]
    tok = CharTok()
    eng = EngineConfig(verifier=VerifierConfig(method="tokenwise", gamma=3),
                       max_new_tokens=10, temperature=1.0)
    tp = bridge.params_from_jax(JPT)
    gen = tuad.make_uad_generate(TCFG, eng, make(tuad), device="cpu")
    out = gen(tp, tok.encode("abcabd"), torch.Generator().manual_seed(2))
    assert 1 <= len(out) <= 10 or out[-1] == 25
    assert all(0 <= t < 26 for t in out)
    again = tuad.make_uad_generate(TCFG, eng, make(tuad), device="cpu")(
        tp, tok.encode("abcabd"), torch.Generator().manual_seed(2))
    assert again == out
