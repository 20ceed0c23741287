"""Distribution-exactness (losslessness) of the port's verifiers: the port
of tests/test_verify_exactness.py on the port's own `verify`.

The committed stream of a lossless verifier is distributed exactly as
target autoregressive sampling. With Markov mock models (tests/
torch_markov.py) the empirical joint of the first T committed tokens must
match the analytic target joint within the JAX file's Monte-Carlo bands,
and must NOT match the draft joint (power check). The tables are the ones
the JAX file draws (markov.random_tables from its keys, handed over as
numpy), so its bands apply unchanged, hsd_ref's bias plateau included;
the trials' noise comes from a torch.Generator.
"""
import jax
import numpy as np
import pytest
import torch

import markov
from torch_markov import (FULL_TRIALS, GAMMA, N_TRIALS, T, TOL, TOL_HSD_REF,
                          V, empirical_joint, jax_tables, run,
                          spec_generate_markov, tv_distance)

torch.set_num_threads(2)


LOSSLESS_CASES = [("tokenwise", 1), ("tokenwise", 4), ("hsd", 1), ("hsd", 4),
                  ("hsd_ref", 1), ("hsd_ref", 4), ("blockwise", 1)]


@pytest.mark.parametrize("method,K", LOSSLESS_CASES)
def test_lossless(method, K):
    emp, target, draft = run(method, K)
    d_target = tv_distance(emp, target)
    assert tv_distance(target, draft) > 0.2
    tol = TOL_HSD_REF[K] if method == "hsd_ref" else TOL
    assert d_target < tol, f"{method} K={K}: TV to target {d_target:.4f}"
    assert tv_distance(emp, draft) > 0.1, (
        f"{method} K={K}: output looks like the draft dist")


@pytest.mark.parametrize("method", ["tokenwise", "hsd"])
def test_lossless_eleven_drafts(method):
    """The main-path cell's K = 11 (parallel) stays exact: the rounds past
    the fourth keep the target's law."""
    emp, target, draft = run(method, 11)
    assert tv_distance(emp, target) < TOL, (method, tv_distance(emp, target))
    assert tv_distance(emp, draft) > 0.1


@pytest.mark.slow
@pytest.mark.parametrize("method,K", LOSSLESS_CASES)
def test_lossless_full(method, K):
    """Full-precision lane: the JAX file's 120k-trial bands."""
    emp, target, draft = run(method, K, n_trials=FULL_TRIALS)
    tol = {1: 0.030, 4: 0.045}[K] if method == "hsd_ref" else 0.035
    assert tv_distance(target, draft) > 0.2
    assert tv_distance(emp, target) < tol, (method, K)
    assert tv_distance(emp, draft) > 0.1


def marginal_first(joint):
    return np.asarray(joint).reshape(V, -1).sum(axis=1)


@pytest.mark.parametrize("method,K,striped", [
    ("tokenwise", 1, False), ("tokenwise", 4, False), ("hsd", 1, False),
    ("hsd", 4, False), ("hsd_ref", 1, False), ("blockwise", 1, False),
    ("tokenwise", 3, True), ("hsd", 3, True)])
def test_first_token_marginal_exact(method, K, striped):
    """The first committed token is exactly p-distributed for every
    verifier, hsd_ref included (its bias touches later positions only)."""
    emp, target, _ = run(method, K, striped=striped)
    d = tv_distance(marginal_first(emp), marginal_first(target))
    assert d < 0.012 * (60_000 / N_TRIALS) ** 0.5, (method, K, d)


def test_greedy_matches_argmax_chain():
    q_table, p_table = jax_tables(jax.random.PRNGKey(3))
    s0 = 0
    buf, count, _ = spec_generate_markov(
        torch.Generator().manual_seed(7), q_table, p_table, s0, 1,
        method="greedy", K=1, gamma=GAMMA, blocks=T)
    want, last = [], s0
    for _ in range(T):
        last = int(p_table[last].argmax())
        want.append(last)
    assert buf[0, :T].tolist() == want


@pytest.mark.parametrize("method,K,striped", [
    ("tokenwise", 1, False), ("hsd", 1, False), ("hsd", 3, False),
    ("blockwise", 1, False), ("tokenwise", 3, True), ("hsd", 3, True)])
def test_identical_models_accept_everything(method, K, striped):
    """p == q: every verifier accepts the full draft every block."""
    q_table, _ = jax_tables(jax.random.PRNGKey(11))
    _, count, ncommits = spec_generate_markov(
        torch.Generator().manual_seed(5), q_table, q_table, 0, 256,
        method=method, K=K, gamma=GAMMA, blocks=4, striped=striped)
    assert bool((count == 4 * (GAMMA + 1)).all()), (method, K, ncommits)


def mean_commit(q_table, p_table, method, K, seed, n=30_000):
    _, counts, _ = spec_generate_markov(
        torch.Generator().manual_seed(seed), q_table, p_table, 0, n,
        method=method, K=K, gamma=GAMMA, blocks=2)
    return float(counts.double().mean()) / 2.0


@pytest.mark.parametrize("method", ["hsd", "hsd_ref"])
def test_hsd_block_efficiency_at_least_tokenwise(method):
    """The paper's headline claim: HSD accepts at least as many tokens per
    block as tokenwise verification (the JAX file's pair and margin)."""
    q_table, p_table = jax_tables(jax.random.PRNGKey(21), 1.5)
    be_tok = mean_commit(q_table, p_table, "tokenwise", 1, 100)
    be_hsd = mean_commit(q_table, p_table, method, 1, 100)
    assert be_hsd >= be_tok - 0.02, (be_tok, be_hsd)


@pytest.mark.parametrize("method", ["tokenwise", "hsd"])
def test_multidraft_improves_acceptance(method):
    """More parallel drafts => strictly more expected accepted tokens."""
    q_table, p_table = jax_tables(jax.random.PRNGKey(33), 1.0)
    be1 = mean_commit(q_table, p_table, method, 1, 200)
    be4 = mean_commit(q_table, p_table, method, 4, 200)
    assert be4 > be1 + 0.02, (method, be1, be4)


@pytest.mark.parametrize("method,K", [("hsd_ref", 4), ("tokenwise", 4)])
def test_joint_matches_jax_harness(method, K):
    """On tables the JAX file does not use (numpy, seed 0), the port's
    committed joint equals tests/markov.py's under JAX within the
    two-sample band: hsd_ref's bias (TV ~0.11 to the target here, outside
    the band calibrated on the JAX file's tables) is the reference's own,
    reproduced, not the port's."""
    rng = np.random.default_rng(0)
    q = rng.dirichlet(np.full(V, 0.6), size=V).astype(np.float32)
    p = rng.dirichlet(np.full(V, 0.6), size=V).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), N_TRIALS)
    jbufs, _, _ = jax.vmap(lambda k: markov.spec_generate_markov(
        k, jax.numpy.asarray(q), jax.numpy.asarray(p), 1, method=method, K=K,
        gamma=GAMMA, blocks=T))(keys)
    tbufs, _, _ = spec_generate_markov(
        torch.Generator().manual_seed(2), torch.from_numpy(q),
        torch.from_numpy(p), 1, N_TRIALS, method=method, K=K, gamma=GAMMA,
        blocks=T)
    ej, et = empirical_joint(jbufs, V, T), empirical_joint(tbufs, V, T)
    # three times the expected TV of two independent N-sample estimates of
    # one joint, 0.5 * sum_i sqrt(4 p_i / (pi N))
    noise = 0.5 * np.sqrt(4 / (np.pi * N_TRIALS)) * np.sqrt(ej).sum()
    assert tv_distance(ej, et) < 3 * noise, (tv_distance(ej, et), noise)
