"""Unit tests of the port's verifier helpers (verify/common.py) and the
structural invariants of its `verify`: the port of tests/
test_verify_units.py, each helper also held against the JAX package's on
the same inputs, and the request-batch case under torch.func.vmap.
"""
import jax.numpy as jnp
import numpy as np
import torch
from torch.func import vmap

from hsd_tpu.verify import common as jcommon
from hsd_tpu_torch.verify import verify
from hsd_tpu_torch.verify.common import (last_true_index, normalize,
                                         prefix_matches, scatter_commit,
                                         window_index)
from hsd_tpu_torch.verify.forward_sampling import forward_sampling_step
from hsd_tpu_torch.verify.hsd import hsd_noise

torch.set_num_threads(2)
i64 = torch.int64


def _t(v):
    return torch.tensor(v, dtype=i64)


def test_last_true_index():
    for flags in ([False, True, False, True, False], [False, False],
                  [True, False], [True, True, True]):
        want = int(jcommon.last_true_index(jnp.asarray(flags)))
        assert int(last_true_index(torch.tensor(flags))) == want
    f = lambda a: int(last_true_index(torch.tensor(a)))
    assert f([False, True, False, True, False]) == 3
    assert f([False, False]) == 0
    assert f([True, False]) == 0
    assert f([True, True, True]) == 2


def test_window_index():
    idx, valid = window_index(_t(2), 5)
    np.testing.assert_array_equal(idx.numpy(), [2, 3, 4, 4, 4])
    np.testing.assert_array_equal(valid.numpy(), [1, 1, 1, 0, 0])
    for m in range(6):
        jidx, jvalid = jcommon.window_index(jnp.int32(m), 5)
        idx, valid = window_index(_t(m), 5)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_scatter_commit():
    row = _t([7, 8, 9])
    for n, want in ((2, [7, 8, 42, 0]), (0, [42, 0, 0, 0]),
                    (3, [7, 8, 9, 42])):
        out = scatter_commit(row, _t(42), _t(n))
        np.testing.assert_array_equal(out.numpy(), want)
        jout = jcommon.scatter_commit(jnp.asarray([7, 8, 9], jnp.int32),
                                      jnp.int32(42), jnp.int32(n))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_prefix_matches():
    d = _t([[1, 2, 3], [1, 2, 4], [9, 2, 3]])
    assert bool(prefix_matches(d, 1, _t(0), _t(2)))
    assert not bool(prefix_matches(d, 2, _t(0), _t(1)))
    assert bool(prefix_matches(d, 2, _t(0), _t(0)))
    assert not bool(prefix_matches(d, 1, _t(0), _t(3)))
    # the striped layout's row is a tensor: same answers
    assert bool(prefix_matches(d, _t(1), _t(0), _t(2)))
    assert not bool(prefix_matches(d, _t(2), _t(0), _t(1)))
    jd = jnp.asarray(d.numpy())
    for b in range(3):
        for ind in range(3):
            for n in range(4):
                want = bool(jcommon.prefix_matches(jd, b, ind, jnp.int32(n)))
                assert bool(prefix_matches(d, _t(b), _t(ind), _t(n))) == want


def test_normalize_zero_mass_fallback():
    z = torch.zeros((4,))
    fb = torch.tensor([0.25, 0.25, 0.25, 0.25])
    np.testing.assert_allclose(normalize(z, fb).numpy(), fb.numpy())
    x = torch.tensor([1.0, 3.0, 0.0, 4.0])
    np.testing.assert_allclose(
        normalize(x, fb).numpy(),
        np.asarray(jcommon.normalize(jnp.asarray(x.numpy()),
                                     jnp.asarray(fb.numpy()))), rtol=1e-7)


def _problem(seed, K=2, gamma=4, V=8):
    rng = np.random.default_rng(seed)
    q = rng.dirichlet(np.ones(V), size=(K, gamma)).astype(np.float32)
    p = rng.dirichlet(np.ones(V), size=(K, gamma + 1)).astype(np.float32)
    d = rng.integers(0, V, size=(K, gamma))
    return torch.from_numpy(d).long(), torch.from_numpy(q), \
        torch.from_numpy(p)


def test_verify_shapes_and_ranges():
    d, q, p = _problem(0)
    K, gamma = d.shape
    for method, k in [("tokenwise", K), ("hsd", K), ("hsd_ref", K),
                      ("blockwise", 1), ("greedy", 1)]:
        res = verify(method, d[:k], q[:k], p[:k],
                     generator=torch.Generator().manual_seed(1))
        assert res.tokens.shape == (gamma + 1,)
        n = int(res.n_matches)
        assert 0 <= n <= gamma
        assert 0 <= int(res.draft_index) < k
        toks = res.tokens.numpy()
        # the accepted prefix is the selected draft's tokens
        np.testing.assert_array_equal(toks[:n],
                                      d[int(res.draft_index)].numpy()[:n])
        assert 0 <= toks[n] < p.shape[-1]


def test_verify_vmap():
    """The verifiers compose with torch.func.vmap over a request batch
    (each request's noise drawn beforehand), and each batch row equals
    the unbatched call on its own inputs."""
    B, K, gamma, V = 3, 2, 4, 8
    probs = [_problem(10 + i, K=K) for i in range(B)]
    d = torch.stack([x[0] for x in probs])
    q = torch.stack([x[1] for x in probs])
    p = torch.stack([x[2] for x in probs])
    gen = torch.Generator().manual_seed(5)
    noise = [hsd_noise(K, gamma, V, gen, "cpu") for _ in range(B)]
    nz = {k: torch.stack([n[k] for n in noise]) for k in noise[0]}

    def one(a, b, c, z):
        res = verify("hsd", a, b, c, noise=z)
        return res.tokens, res.n_matches, res.draft_index

    toks, n, ind = vmap(one)(d, q, p, nz)
    assert toks.shape == (B, gamma + 1)
    assert n.shape == (B,)
    for i in range(B):
        res = verify("hsd", d[i], q[i], p[i], noise=noise[i])
        assert torch.equal(toks[i], res.tokens)
        assert int(n[i]) == int(res.n_matches)
        assert int(ind[i]) == int(res.draft_index)


def test_telemetry_channel():
    d, q, p = _problem(9, K=1)
    res, tel = verify("hsd", d, q, p, generator=torch.Generator().manual_seed(2),
                      return_telemetry=True)
    K, gamma = d.shape
    # one telemetry row per multidraft round
    assert tel.step_back_probs.shape == (K, gamma)
    sbp = tel.step_back_probs.numpy()
    assert ((sbp >= 0) & (sbp <= 1)).all()
    # round 0 always runs: its p_i row is populated
    assert tel.p_i[0].max() > 0


def test_forward_sampling_step():
    V, L = 8, 4
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.dirichlet(np.ones(V), size=L).astype(np.float32))
    p = torch.from_numpy(rng.dirichlet(np.ones(V),
                                       size=L + 1).astype(np.float32))
    cand = _t([1, 2, 3, 0])
    toks, n = forward_sampling_step(cand, q, p, 3, last_step=True,
                                    generator=torch.Generator().manual_seed(2))
    assert toks.shape == (2,)
    assert int(n) in (0, 1)
    assert 0 <= int(toks[0]) < V
    # not the last step: nothing is accepted
    toks2, n2 = forward_sampling_step(cand, q, p, 3, last_step=False,
                                      generator=torch.Generator().manual_seed(3))
    assert int(n2) == 0
