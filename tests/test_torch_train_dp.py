"""Data-parallel EAGLE head training and ZeRO-sharded Adam moments (the
mesh cases of tests/test_train.py), on gloo ranks on the CPU.

* A data-parallel step (dp 2, one row a rank) == the single-process step
  on the whole batch (loss and every metric rtol 1e-5, the trained
  leaves rtol 1e-4 / atol 1e-5: the JAX file's bounds) and == the JAX
  package's step on the whole batch (the port-vs-JAX bounds of
  tests/test_torch_train.py: loss 1e-4 relative, leaves 2e-5).
* ZeRO over dp 4: the same two steps as the replicated optimizer, each
  rank holding a quarter of the moment bytes, its moments the slices of
  the replicated ones along the dims `zero_opt_shardings` names (== JAX's
  specs).
* The EAGLE-1 step with ZeRO over dp 2 == its single-process step.
* `bridge.train_state_from_jax(zero_mesh=...)` keeps each rank's slices
  of JAX's replicated moments.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu.models.eagle import init_eagle_params as j_init_eagle
from hsd_tpu.models.eagle import init_eagle_params_v1 as j_init_eagle_v1
from hsd_tpu.parallel import make_mesh as j_make_mesh
from hsd_tpu.train import eagle3 as je3
from hsd_tpu_torch import bridge
from hsd_tpu_torch.parallel import run_ranks
from hsd_tpu_torch.train import eagle1 as te1
from hsd_tpu_torch.train import eagle3 as te3
from test_torch_train import (ECFG, FL, JECFG, JTCFG, TC, TCFG, _ids, _jtc)

torch.set_num_threads(2)
DP_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    jt = j_init_params(JTCFG, jax.random.PRNGKey(0))
    je = j_init_eagle(JECFG, jax.random.PRNGKey(1))
    return jt, bridge.params_from_jax(jt), je, bridge.eagle_params_from_jax(je)


def _single(tt, te, batches, version=3, ecfg=ECFG):
    state = te3.init_train_state(te, TC)
    step = (te3.make_train_step(TCFG, ecfg, TC, FL) if version == 3
            else te1.make_eagle1_train_step(TCFG, ecfg, TC))
    metrics = []
    for ids, lm in batches:
        state, m = step(state, tt, ids, lm)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {k: v.detach() for k, v in
                     te3.trainable_leaves(state.params)}, state


def _same(dp, single):
    m_dp, leaves_dp = dp["metrics"], dp["leaves"]
    m_one, leaves_one = single
    for a, b in zip(m_dp, m_one):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    for k, v in leaves_one.items():
        np.testing.assert_allclose(leaves_dp[k].numpy(), v.numpy(),
                                   **DP_TOL, err_msg=k)


def _dp_batches():
    lm = np.ones((2, 16), np.float32)
    lm[1, 11:] = 0.0               # unequal masks: the acc denominators
    return [(_ids(2), lm), (_ids(3), lm)]


def _zero_batches():
    return [(np.concatenate([_ids(2)] * 2), np.ones((4, 16), np.float32))] * 2


def _v1(pair):
    ecfg = dataclasses.replace(ECFG, version=1)
    te = bridge.eagle_params_from_jax(
        j_init_eagle_v1(dataclasses.replace(JECFG, version=1),
                        jax.random.PRNGKey(1)))
    return ecfg, te, [(_ids(2), np.ones((2, 16), np.float32))]


@pytest.fixture(scope="module")
def runs(pair):
    """DP 2 (replicated moments) and the EAGLE-1 ZeRO step in one world of
    2; ZeRO over DP 4 in one world of 4."""
    _, tt, _, te = pair
    ecfg1, te1, b1 = _v1(pair)
    w2 = run_ranks(R.batch, 2, [
        ("train_steps", (TCFG, ECFG, TC, tt, te, _dp_batches(), 2, False, 3,
                         FL)),
        ("train_steps", (TCFG, ecfg1, TC, tt, te1, b1, 2, True, 1))],
        device="cpu")
    w4 = run_ranks(R.batch, 4, [
        ("train_steps", (TCFG, ECFG, TC, tt, te, _zero_batches(), 4, True, 3,
                         FL))], device="cpu")
    return dict(dp=[r[0] for r in w2], eagle1=[r[1] for r in w2],
                zero=[r[0] for r in w4])


def test_data_parallel_step_matches_single(pair, runs):
    jt, tt, je, te = pair
    batches = _dp_batches()
    single = _single(tt, te, batches)
    res = runs["dp"]
    for out in res:
        _same(out, single[:2])
    # the JAX package's steps on the whole batch
    jstep = je3.make_train_step(JTCFG, JECFG, _jtc(TC), FL)
    js = je3.init_train_state(je, _jtc(TC))
    for ids, m in batches:
        js, jm = jstep(js, jt, jnp.asarray(ids), jnp.asarray(m))
    assert abs(res[0]["metrics"][-1]["loss"] - float(jm["loss"])) <= \
        1e-4 * abs(float(jm["loss"]))
    for k, v in res[0]["leaves"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(getattr(js.params, k)),
                                   rtol=0, atol=2e-5, err_msg=k)


def test_zero_sharded_step_matches_replicated(pair, runs):
    jt, tt, je, te = pair
    single, leaves, state = _single(tt, te, _zero_batches())
    full_bytes = sum(t.numel() * t.element_size()
                     for st in state.opt.state.values()
                     for k, t in st.items() if k != "step")
    # JAX's moment specs for these leaves
    mesh = j_make_mesh(data=4, model=1)
    jstate = je3.init_train_state(je, _jtc(TC))
    jspec = je3.zero_opt_shardings(jstate.opt_state, mesh)[1][0].mu
    mesh4 = R.fake_mesh((4, 1), ("data", "model"), 0)
    specs = te3.zero_opt_shardings(te, mesh4)
    assert specs == {k: tuple(jspec[k].spec) + (None,) * (
        len(specs[k]) - len(jspec[k].spec)) for k in specs}
    sd = state.opt.state_dict()["state"]
    for r, out in enumerate(runs["zero"]):
        _same(out, (single, leaves))
        assert out["moment_bytes"] * 4 == full_bytes
        # the gathered moments are the replicated optimizer's
        for i, st in out["opt"]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_allclose(st[k].numpy(), sd[i][k].numpy(),
                                           rtol=1e-4, atol=1e-9)


def test_eagle1_zero_sharded_step(pair, runs):
    jt, tt, _, _ = pair
    ecfg, te, batches = _v1(pair)
    single = _single(tt, te, batches, version=1, ecfg=ecfg)
    for out in runs["eagle1"]:
        _same(out, single[:2])


def test_train_state_from_jax_slices_for_zero(pair):
    jt, tt, je, te = pair
    jstep = je3.make_train_step(JTCFG, JECFG, _jtc(TC), FL)
    js, _ = jstep(je3.init_train_state(je, _jtc(TC)), jt,
                  jnp.asarray(_ids(30)), jnp.ones((2, 16), jnp.float32))
    adam = js.opt_state[1][0]
    full = bridge.train_state_from_jax(js, TC)
    for r in range(2):
        z = bridge.train_state_from_jax(
            js, TC, zero_mesh=R.fake_mesh((2, 1), ("data", "model"), r))
        assert z.step == full.step == 1
        assert z.opt.param_groups[0]["lr"] == full.opt.param_groups[0]["lr"]
        names = [k for k, _ in te3.trainable_leaves(z.params)]
        for i, (name, d) in enumerate(zip(names, z.opt.dims)):
            st = z.opt.opt.state[z.opt.shards[i]]
            mu = torch.from_numpy(np.array(adam.mu[name]))
            n = mu.shape[d] // 2
            np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                          mu.narrow(d, r * n, n).numpy())
