"""The port's sequence-parallel ring prefill (parallel/sp.py,
ops/ring_attention.py) against the JAX package (the cases of
tests/test_sp.py), on gloo ranks on the CPU.

* The sp-sharded prefill's logits and cache == JAX's single-device
  forward (sp 2 and 4) within 1e-4 (f32; the JAX file's own bound is
  3e-2); every rank's cache length is T.
* Decoding one token from the gathered cache == decoding it from JAX's
  single-device prefill cache (same argmax, logits within 1e-4).
* Ring attention == dense causal softmax attention, GQA, f32, within the
  JAX file's 1e-5.
"""
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
from hsd_tpu_torch import bridge
from hsd_tpu_torch.parallel import run_ranks
from test_torch_tp import tcfg

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
JCFG = JCfg.tiny(vocab_size=64, hidden_size=32, intermediate_size=64,
                 num_layers=3, num_heads=4, num_kv_heads=2)
CFG = tcfg(JCFG)


T_PRE, T_DEC, S_DEC = 16, 16, 24
PRE_TOKS = np.asarray(((np.arange(T_PRE) * 7) % 50)[None, :] + 1, np.int32)
DEC_TOKS = np.asarray(((np.arange(T_DEC) * 5) % 50)[None, :] + 1, np.int32)
NXT = np.asarray([[7]], np.int32)
B, T, H, Hkv, d = 1, 12, 4, 2, 8
_rng = np.random.default_rng(0)
QKV = tuple(_rng.normal(0, 1, s).astype(np.float32)
            for s in ((B, T, H, d), (B, T, Hkv, d), (B, T, Hkv, d)))


@pytest.fixture(scope="module")
def runs():
    """sp 2 and the decode after gather_cache in one world of 2; sp 4 and
    the standalone ring in one world of 4."""
    tp = bridge.params_from_jax(j_init_params(JCFG, jax.random.PRNGKey(0)))
    pre = torch.from_numpy(PRE_TOKS).long()
    w2 = run_ranks(R.batch, 2, [
        ("sp_prefill", (CFG, tp, pre, 2)),
        ("sp_prefill", (CFG, tp, torch.from_numpy(DEC_TOKS).long(), 2,
                        S_DEC, torch.from_numpy(NXT).long()))], device="cpu")
    w4 = run_ranks(R.batch, 4, [
        ("sp_prefill", (CFG, tp, pre, 4)),
        ("ring", tuple(torch.from_numpy(a) for a in QKV))], device="cpu")
    return {2: [r[0] for r in w2], "decode": [r[1] for r in w2],
            4: [r[0] for r in w4], "ring": [r[1] for r in w4]}


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_prefill_matches_single(runs, sp):
    jp = j_init_params(JCFG, jax.random.PRNGKey(0))
    ref, ref_cache = jtr.forward(JCFG, jp, jnp.asarray(PRE_TOKS),
                                 j_init_cache(JCFG, 1, T_PRE))
    res = runs[sp]
    Tc = T_PRE // sp
    for i, out in enumerate(res):
        assert out["length"] == T_PRE
        np.testing.assert_allclose(out["logits"].numpy(), np.asarray(ref),
                                   **TOL)
        np.testing.assert_allclose(
            out["k"].numpy(),
            np.asarray(ref_cache.k)[:, :, i * Tc:(i + 1) * Tc], **TOL)
        assert torch.equal(out["logits"], res[0]["logits"])


def test_sp_cache_continues_decode(runs):
    jp = j_init_params(JCFG, jax.random.PRNGKey(0))
    _, ref_cache = jtr.forward(JCFG, jp, jnp.asarray(DEC_TOKS),
                               j_init_cache(JCFG, 1, S_DEC))
    l_ref, _ = jtr.forward(JCFG, jp, jnp.asarray(NXT), ref_cache)
    for out in runs["decode"]:
        assert out["gathered_k"].shape[2] == S_DEC
        np.testing.assert_allclose(out["gathered_k"].numpy(),
                                   np.asarray(ref_cache.k), **TOL)
        got = out["next_logits"].numpy()
        np.testing.assert_allclose(got, np.asarray(l_ref), **TOL)
        assert int(got[0, -1].argmax()) == int(np.asarray(l_ref)[0, -1]
                                               .argmax())


def test_ring_attention_exact_vs_dense(runs):
    q, k, v = QKV
    rep = H // Hkv
    qg = q.reshape(B, T, Hkv, rep, d) * (d ** -0.5)
    scores = jnp.einsum("btkrd,bskd->btkrs", qg, k)
    mask = np.arange(T)[:, None] >= np.arange(T)[None, :]
    scores = jnp.where(mask[None, :, None, None, :], scores, -1e30)
    ref = jnp.einsum("btkrs,bskd->btkrd", jax.nn.softmax(scores, -1),
                     v).reshape(B, T, H, d)
    for out in runs["ring"]:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
