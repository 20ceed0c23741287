"""The port's tensor parallelism (parallel/tp.py) against the JAX
package's shard_map TP (the forward cases of tests/test_tp_pallas.py).

The ranks run under gloo on the CPU, each with the kernels' plain
versions on its Megatron shard. Tolerances are the JAX file's: 3e-3 for
the quantized forwards (its interpret-mode Pallas kernels against the
port's plain versions, f32), 2e-4 for the dense MoE.

* The int8 TP forward at tp 4 == JAX's `make_tp_forward` on a (1, 4)
  mesh, logits and every rank's kv-head shard of the cache; 2 psums a
  layer and one logits gather per forward.
* Decode == prefill under TP (5 + 3 tokens against 8).
* MoE with expert parallelism (8 experts, 4 a rank) == JAX's
  single-device forward, and the GSPMD layout's per-expert ffn split.
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
from hsd_tpu.ops.linear import QuantizedLinear as JQL
from hsd_tpu.ops.linear import quantize as j_quantize
from hsd_tpu.parallel import make_mesh as j_make_mesh
from hsd_tpu.parallel.tp import make_tp_forward as j_make_tp_forward
from hsd_tpu.parallel.tp import shard_params_tp as j_shard_params_tp
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import ModelConfig
from hsd_tpu_torch.parallel import run_ranks

torch.set_num_threads(2)
QTOL = dict(rtol=3e-3, atol=3e-3)
JCFG = dataclasses.replace(
    JCfg.tiny(vocab_size=512, num_heads=8, num_kv_heads=4, hidden_size=512,
              intermediate_size=512, num_layers=2),
    tie_word_embeddings=False, attention_bias=False, gptq_path="pallas")


def tcfg(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "head_dim", "rope_theta",
        "rms_norm_eps", "tie_word_embeddings", "attention_bias",
        "eos_token_id", "num_experts", "num_experts_per_tok")},
        dtype=torch.float32)


def quantize_params(params, bits=8, gs=128):
    """test_tp_pallas's `_quantize_params`: every big matmul per layer."""
    dl = dict(params.layers)
    for name in ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown"):
        w = params.layers[name]
        qs = [j_quantize(w[i].astype(jnp.float32), bits=bits, group_size=gs)
              for i in range(w.shape[0])]
        dl[name] = JQL(qweight=jnp.stack([q.qweight for q in qs]),
                       scales=jnp.stack([q.scales for q in qs]),
                       zeros=jnp.stack([q.zeros for q in qs]))
    lm = j_quantize(params.lm_head.astype(jnp.float32), bits=bits,
                    group_size=gs)
    return params._replace(layers=dl, lm_head=lm)


CFG = tcfg(JCFG)


def test_tp_forward_matches_jax_tp():
    params = quantize_params(j_init_params(JCFG, jax.random.PRNGKey(0)))
    toks = np.asarray((np.arange(10) % 400).reshape(1, 10) + 1, np.int32)
    mesh = j_make_mesh(data=1, model=4)
    with jax.set_mesh(mesh):
        jref, jcache = j_make_tp_forward(JCFG, params)(
            j_shard_params_tp(params, mesh), jnp.asarray(toks),
            j_init_cache(JCFG, 1, 16))
    jref, jk = np.asarray(jref, np.float32), np.asarray(jcache.k, np.float32)
    res = run_ranks(R.tp_forward, 4, CFG, bridge.params_from_jax(params),
                    torch.from_numpy(toks).long(), 16, (1, 4), device="cpu")
    for m, out in enumerate(res):
        np.testing.assert_allclose(out["logits"][0].numpy(), jref, **QTOL)
        np.testing.assert_allclose(out["k"].numpy(), jk[:, :, :, m:m + 1],
                                   **QTOL)
        assert out["counts"] == dict(psum=2 * CFG.num_layers, all_gather=1,
                                     ppermute=0, broadcast=0)
        assert torch.equal(out["logits"][0], res[0]["logits"][0])


def _moe_case():
    jcfg = dataclasses.replace(
        JCfg.tiny_moe(vocab_size=256, num_heads=8, num_kv_heads=4,
                      hidden_size=64, intermediate_size=96, num_experts=8),
        tie_word_embeddings=False)
    return jcfg, j_init_params(jcfg, jax.random.PRNGKey(2))


MOE_TOKS = np.asarray((np.arange(10) % 200).reshape(1, 10) + 1, np.int32)
LAYOUTS = ("tp", "gspmd", "gspmd_ep")


@pytest.fixture(scope="module")
def world2():
    """The world-of-2 cases in one spawn: the 8-token prefill, the 5 + 3
    token one, and the MoE forward under each layout."""
    params = bridge.params_from_jax(
        quantize_params(j_init_params(JCFG, jax.random.PRNGKey(1))))
    toks = (torch.arange(8) % 200).reshape(1, 8) + 1
    jcfg, jp = _moe_case()
    moe = [("tp_forward", (tcfg(jcfg), bridge.params_from_jax(jp),
                           torch.from_numpy(MOE_TOKS).long(), 16, (1, 2),
                           layout)) for layout in LAYOUTS]
    res = run_ranks(R.batch, 2, [
        ("tp_forward", (CFG, params, toks, 16, (1, 2))),
        ("tp_forward", (CFG, params, toks, 16, (1, 2), "tp", None,
                        [(0, 5), (5, 8)]))] + moe, device="cpu")
    return dict(full=[r[0] for r in res], part=[r[1] for r in res],
                **{layout: [r[2 + k] for r in res]
                   for k, layout in enumerate(LAYOUTS)})


def test_tp_decode_matches_prefill(world2):
    for f, p in zip(world2["full"], world2["part"]):
        np.testing.assert_allclose(p["logits"][1].numpy(),
                                   f["logits"][0][:, 5:].numpy(), **QTOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_moe_expert_parallel_matches_single(world2, layout):
    """MoE under TP: the expert axis split (tp, and the GSPMD layout with
    expert_parallel: 4 experts a rank) or every expert's ffn split (gspmd,
    expert_parallel off), the f32 mix psummed == JAX's single-device
    forward."""
    jcfg, jp = _moe_case()
    ref, _ = jax.jit(lambda p, t, c: jtr.forward(jcfg, p, t, c))(
        jp, jnp.asarray(MOE_TOKS), j_init_cache(jcfg, 1, 16))
    for out in world2[layout]:
        np.testing.assert_allclose(out["logits"][0].numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=2e-4, atol=2e-4)
