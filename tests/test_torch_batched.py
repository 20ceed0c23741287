"""The port's make_generate_batched (B requests in lockstep on a slot pool)
on the CPU, against the JAX package's vmap of make_generate and the port's
own make_generate.

* Greedy (temperature 0): every row's committed stream and length equal
  JAX's make_generate_batched on a bridged tiny dense pair (float32), at
  K = 1 and K = 2 parallel and striped, prompts of different lengths.
* Sampled: row b equals make_generate on request b with generator b,
  token for token, with the same blocks and accepts (tests/test_utils.py's
  contract), for hsd, tokenwise and blockwise at K = 1 and the multidraft
  layouts. The pooled products see B times make_generate's rows; on the
  CPU the float32 roundings that may differ are ~1e-7, and the pinned
  seeds have no decision that near a tie.
* The result's layout, and a request finishing (EOS or budget) blocks
  before the others stays frozen.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsd_tpu.config import EngineConfig as JEng
from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.config import VerifierConfig as JVer
from hsd_tpu.engine import make_generate_batched as j_batched
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine.speculative import (make_generate,
                                              make_generate_batched)
from hsd_tpu_torch.models import init_params

torch.set_num_threads(2)
CFG = ModelConfig.tiny(vocab_size=64)
PD = init_params(CFG, seed=0, device="cpu")
PT = init_params(CFG, seed=1, device="cpu")
P = 12


def _prompts(B=3):
    rng = np.random.default_rng(1)
    plens = [12, 7, 4, 9][:B]
    rows = np.zeros((B, P), np.int32)
    for b, n in enumerate(plens):
        rows[b, P - n:] = rng.integers(1, 60, (n,))
    return rows, plens


def _eng(method, K, parallel, temperature, max_new=12, gamma=3):
    return EngineConfig(verifier=VerifierConfig(method=method, gamma=gamma,
                                                num_drafts=K,
                                                parallel=parallel),
                        max_new_tokens=max_new, temperature=temperature)


@pytest.mark.parametrize("K,parallel,method", [(1, True, "greedy"),
                                               (2, True, "hsd"),
                                               (2, False, "tokenwise")])
def test_greedy_rows_equal_jax_batched(K, parallel, method):
    jcfg = JCfg.tiny(vocab_size=64)
    jd = j_init_params(jcfg, jax.random.PRNGKey(0))
    jt = j_init_params(jcfg, jax.random.PRNGKey(1))
    jeng = JEng(verifier=JVer(method=method, gamma=3, num_drafts=K,
                              parallel=parallel),
                max_new_tokens=12, temperature=0.0)
    prompts, plens = _prompts()
    jres = j_batched(jcfg, jcfg, jeng)(
        jd, jt, jnp.asarray(prompts), jnp.asarray(plens, jnp.int32),
        jax.random.split(jax.random.PRNGKey(2), len(plens)))
    tres = make_generate_batched(CFG, CFG, _eng(method, K, parallel, 0.0))(
        bridge.params_from_jax(jd), bridge.params_from_jax(jt),
        torch.from_numpy(prompts).long(), plens, [None] * len(plens))
    for b in range(len(plens)):
        n = int(jres.length[b])
        assert int(tres.length[b]) == n
        np.testing.assert_array_equal(tres.tokens[b, P:n].numpy(),
                                      np.asarray(jres.tokens)[b, P:n])
        assert int(tres.ncommit[b]) == int(jres.ncommit[b])


@pytest.mark.parametrize("method,K,parallel", [
    ("hsd", 1, True), ("tokenwise", 1, True), ("blockwise", 1, True),
    ("hsd_ref", 2, True), ("hsd", 2, False), ("tokenwise", 2, False)])
def test_sampled_row_equals_make_generate(method, K, parallel):
    eng = _eng(method, K, parallel, 1.0)
    prompts, plens = _prompts(4)
    prompts = torch.from_numpy(prompts).long()
    bres = make_generate_batched(CFG, CFG, eng)(
        PD, PT, prompts, plens,
        [torch.Generator().manual_seed(20 + b) for b in range(4)])
    gen = make_generate(CFG, CFG, eng)
    for b in range(4):
        res = gen(PD, PT, prompts[b], plens[b],
                  torch.Generator().manual_seed(20 + b))
        assert int(bres.length[b]) == res.length
        assert torch.equal(bres.tokens[b, :res.length],
                           res.tokens[:res.length])
        assert int(bres.blocks[b]) == res.blocks
        assert torch.equal(bres.accepts[b], res.accepts)
        assert torch.equal(bres.draft_lens[b], res.draft_lens)


def test_result_layout_and_frozen_rows():
    """Budgets and EOS end rows at different blocks; a finished row stays
    frozen (its committed tokens and length unchanged) while the others
    decode, and the tensors carry a leading B axis."""
    eng = _eng("hsd", 1, True, 1.0, max_new=16)
    prompts, plens = _prompts(4)
    bres = make_generate_batched(CFG, CFG, eng)(
        PD, PT, torch.from_numpy(prompts).long(),
        torch.tensor(plens), [torch.Generator().manual_seed(b)
                              for b in range(4)])
    S = P + 16 + 3 + 2
    assert bres.tokens.shape == (4, S) and bres.prompt_len == P
    assert bres.accepts.shape == bres.draft_lens.shape == (4, 16)
    assert bres.length.shape == bres.blocks.shape == (4,)
    assert torch.equal(bres.ncommit, bres.length - P)
    assert len(set(bres.blocks.tolist())) > 1      # rows ended apart
    for b in range(4):
        n = int(bres.blocks[b])
        assert (bres.accepts[b, :n] >= 0).all() and \
            (bres.accepts[b, n:] == -1).all()
        assert 1 <= int(bres.ncommit[b]) <= 16
        assert torch.equal(bres.tokens[b, :P],
                           torch.from_numpy(prompts[b]).long())
    with pytest.raises(ValueError):
        make_generate_batched(CFG, CFG, eng)(
            PD, PT, torch.from_numpy(prompts).long(), plens[:3],
            [None] * 4)
