"""The port's pipeline parallelism (parallel/pp.py) against the JAX
package (the cases of tests/test_pp.py), on gloo ranks on the CPU.

A stage runs the single-card layers on its [L/pp] slice and hands its
hidden on exactly, so the PP logits and each stage's cache equal the
port's single-card forward bit for bit, and JAX's within the port's f32
logit tolerance (2e-3, tests/test_torch_model.py's; the JAX file's own
bound is 2e-2). The PP target inside make_generate commits the
single-card run's tokens on the same generator; PP x TP (2 x 2) matches
within the same tolerance and decodes the same tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from hsd_tpu.config import ModelConfig as JCfg
from hsd_tpu.engine import init_cache as j_init_cache
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu.models import transformer as jtr
from hsd_tpu.ops.linear import quantize as j_quantize
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, VerifierConfig
from hsd_tpu_torch.engine import make_generate
from hsd_tpu_torch.engine.kvcache import init_cache
from hsd_tpu_torch.models import transformer as ttr
from hsd_tpu_torch.parallel import run_ranks
from test_torch_tp import tcfg

torch.set_num_threads(2)
TOL = dict(rtol=2e-3, atol=2e-3)
JCFG = JCfg.tiny(vocab_size=64, hidden_size=32, intermediate_size=64,
                 num_layers=4, num_heads=4, num_kv_heads=2)
CFG = tcfg(JCFG)
TOKS = np.asarray((np.arange(6) % 50)[None, :] + 1, np.int32)


def _quantized_case():
    jcfg = JCfg.tiny(vocab_size=64, hidden_size=256, intermediate_size=256,
                     num_layers=2, num_heads=4, num_kv_heads=4, head_dim=64)
    pt = j_init_params(jcfg, jax.random.PRNGKey(1))
    q = dict(pt.layers)
    for name in ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown"):
        q[name] = jax.vmap(lambda w: j_quantize(w, bits=8, group_size=128))(
            pt.layers[name].astype(jnp.float32))
    return jcfg, pt._replace(layers=q)


def _engine_pair(jcfg):
    pd = bridge.params_from_jax(j_init_params(JCFG, jax.random.PRNGKey(0)))
    pt = bridge.params_from_jax(j_init_params(jcfg, jax.random.PRNGKey(1)))
    eng = EngineConfig(verifier=VerifierConfig(method="hsd", gamma=3),
                       max_new_tokens=10)
    prompt = torch.arange(8) % 20 + 1
    ref = make_generate(CFG, tcfg(jcfg), eng)(
        pd, pt, prompt, 8, torch.Generator().manual_seed(5))
    return pd, pt, eng, prompt, ref


def _fwd_call(jcfg, jp, pp, tp=1, S=16):
    return ("pp_forward", (tcfg(jcfg), bridge.params_from_jax(jp),
                           torch.from_numpy(TOKS).long(), S, pp, tp))


UNTIED = dataclasses.replace(JCFG, tie_word_embeddings=False)


@pytest.fixture(scope="module")
def runs():
    """Every case's ranks: pp 2, the quantized stack and the engine in one
    world of 2; pp 4 and PP x TP (forward and engine) in one world of 4."""
    jp = j_init_params(JCFG, jax.random.PRNGKey(0))
    jq = _quantized_case()
    pd, pt, eng, prompt, _ = _engine_pair(JCFG)
    w2 = run_ranks(R.batch, 2, [
        _fwd_call(JCFG, jp, 2), _fwd_call(*jq, 2, S=8),
        ("pp_generate", (CFG, CFG, pd, pt, eng, prompt, 8, 5, 2))],
        device="cpu")
    jt = j_init_params(UNTIED, jax.random.PRNGKey(1))
    pd, pt, eng, prompt, _ = _engine_pair(UNTIED)
    w4 = run_ranks(R.batch, 4, [
        _fwd_call(JCFG, jp, 4), _fwd_call(UNTIED, jt, 2, tp=2),
        ("pp_generate", (CFG, tcfg(UNTIED), pd, pt, eng, prompt, 8, 5, 2,
                         2))], device="cpu")
    return dict(pp2=[r[0] for r in w2], quant=[r[1] for r in w2],
                engine=[r[2] for r in w2], pp4=[r[0] for r in w4],
                pptp=[r[1] for r in w4], pptp_engine=[r[2] for r in w4])


def _check(res, jcfg, jp, pp, tp=1, S=16):
    ref, ref_cache = jtr.forward(jcfg, jp, jnp.asarray(TOKS),
                                 j_init_cache(jcfg, 1, S))
    cfg, p = tcfg(jcfg), bridge.params_from_jax(jp)
    one, one_cache = ttr.forward(cfg, p, torch.from_numpy(TOKS).long(),
                                 init_cache(cfg, 1, S, "cpu"))
    L = cfg.num_layers // pp
    kv = cfg.num_kv_heads // tp
    for r, out in enumerate(res):
        s, m = divmod(r, tp)
        np.testing.assert_allclose(out["logits"].numpy(), np.asarray(ref),
                                   **TOL)
        assert out["length"] == int(ref_cache.length)
        np.testing.assert_allclose(
            out["k"].numpy(),
            np.asarray(ref_cache.k)[s * L:(s + 1) * L, :, :,
                                    m * kv:(m + 1) * kv], **TOL)
        if tp == 1:      # the same layers, an exact hand-off: bit-equal
            assert torch.equal(out["logits"], one)
            assert torch.equal(out["k"], one_cache.k[s * L:(s + 1) * L])
        assert out["counts"]["broadcast"] == pp
        assert torch.equal(out["logits"], res[0]["logits"])


@pytest.mark.parametrize("pp", [2, 4])
def test_pp_forward_matches_single(runs, pp):
    _check(runs[f"pp{pp}"], JCFG, j_init_params(JCFG, jax.random.PRNGKey(0)),
           pp)


def test_pp_forward_quantized_stack(runs):
    _check(runs["quant"], *_quantized_case(), 2, S=8)


def test_pp_speculative_engine_matches_single(runs):
    ref = _engine_pair(JCFG)[-1]
    for toks, length in runs["engine"]:
        assert length == ref.length
        assert torch.equal(toks[:length], ref.tokens[:length])


def test_pp_tp_forward_matches_single(runs):
    _check(runs["pptp"], UNTIED, j_init_params(UNTIED, jax.random.PRNGKey(1)),
           2, tp=2)
    ref = _engine_pair(UNTIED)[-1]
    for toks, length in runs["pptp_engine"]:
        assert length == ref.length
        assert torch.equal(toks[:length], ref.tokens[:length])
