"""Markov-chain harness for the port's verifiers: the counterpart of
tests/markov.py, for distribution-exactness (losslessness) tests.

Draft and target "models" are first-order Markov tables q_table / p_table
[V, V] (row = previous token, column = next-token probability), float32
tensors. `spec_generate_markov` runs `blocks` speculative blocks
for N independent trials at once: the drafts are sampled for every trial
in one batched step per position (Gumbel-max on pre-drawn noise), and the
port's own `verify` runs over the trials under `torch.func.vmap` with each
trial's noise bundle drawn beforehand from a torch.Generator, so nothing
random happens inside vmap. Losslessness means the first T committed
tokens are distributed exactly as T steps of autoregressive sampling from
p_table (`ar_joint`). `run` is tests/test_verify_exactness.py's `_run`
on the tables that file draws (markov.random_tables from its keys, handed
over as numpy), so that file's Monte-Carlo bands apply unchanged.
"""
from __future__ import annotations

import jax
import numpy as np
import torch
from torch.func import vmap

import markov
from hsd_tpu_torch.ops.sampling import gumbel, uniform
from hsd_tpu_torch.verify import verify

V = 5
T = 3
GAMMA = 3
FULL_TRIALS = 120_000
N_TRIALS = 24_000
# tests/test_verify_exactness.py's bands (:28-58): Monte-Carlo TV noise
# scales ~ 1/sqrt(N); hsd_ref adds its bias plateau
MC_SCALE = max(1.0, (FULL_TRIALS / N_TRIALS) ** 0.5)
TOL = 0.035 * MC_SCALE
TOL_HSD_REF = {1: 0.022 + 0.008 * MC_SCALE, 4: 0.033 + 0.012 * MC_SCALE}


def _noise(method: str, N: int, K: int, gamma: int, V: int,
           gen: torch.Generator):
    """Each trial's verifier noise bundle, batched over N trials (the
    layouts of verify/*.py's *_noise helpers)."""
    def U(*shape):
        return uniform((N,) + shape, gen, "cpu")

    def G(*shape):
        return gumbel((N,) + shape, gen, "cpu")

    if method == "tokenwise":
        return {"u": U(K, gamma), "gumbel": G(V)}
    if method in ("hsd", "hsd_ref"):
        return {"u": U(K, gamma), "u2": U(K), "gumbel": G(V)}
    if method == "blockwise":
        return {"gumbel": G(gamma, V + 1), "u": U(),
                "gumbel_bonus": G(V)}
    return None                                   # greedy draws nothing


def _sample(probs: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Gumbel-max draw over the last axis (probs strictly positive)."""
    return torch.argmax(torch.log(probs) + gumbel(probs.shape, gen, "cpu"),
                        dim=-1)


def draft_markov(q_table: torch.Tensor, last: torch.Tensor, gamma: int,
                 K: int, striped: bool, gen: torch.Generator) -> torch.Tensor:
    """Draft rows [N, R, gamma] for N trials whose newest token is `last`
    [N]: K independent rows, or the striped tree's R = 1 + gamma * (K - 1)
    rows (a row whose activation step is later than j takes row 0's token
    at step j, as `draft_rows` does)."""
    N = last.shape[0]
    R = 1 + gamma * (K - 1) if striped else K
    act = torch.cat([torch.zeros((1,), dtype=torch.int64),
                     torch.arange(gamma).repeat_interleave(K - 1)]
                    if striped else [torch.zeros((R,), dtype=torch.int64)])
    prev = last[:, None].expand(N, R)
    toks = []
    for j in range(gamma):
        tok = _sample(q_table[prev], gen)                       # [N, R]
        tok = torch.where(act > j, tok[:, :1], tok)
        toks.append(tok)
        prev = tok
    return torch.stack(toks, dim=-1)


def spec_generate_markov(gen: torch.Generator, q_table: torch.Tensor,
                         p_table: torch.Tensor, s0: int, n_trials: int, *,
                         method: str, K: int, gamma: int, blocks: int,
                         striped: bool = False):
    """Run `blocks` speculative blocks for each of n_trials trials from the
    token s0. Returns (buf [N, blocks * (gamma + 1)] committed tokens, count
    [N] committed per trial, ncommits [N, blocks])."""
    N = n_trials
    V = q_table.shape[0]
    buf_len = blocks * (gamma + 1)
    buf = torch.zeros((N, buf_len), dtype=torch.int64)
    off = torch.zeros((N,), dtype=torch.int64)
    last = torch.full((N,), s0, dtype=torch.int64)
    pos = torch.arange(buf_len)

    def one(d, q, p, nz):
        res = verify(method, d, q, p, noise=nz, num_drafts=K,
                     striped=striped)
        return res.tokens, res.n_matches

    batched = vmap(one, in_dims=(0, 0, 0, 0 if method != "greedy" else None))
    ncommits = []
    for _ in range(blocks):
        drafts = draft_markov(q_table, last, gamma, K, striped, gen)
        R = drafts.shape[1]
        prevs = torch.cat([last[:, None, None].expand(N, R, 1), drafts], -1)
        q = q_table[prevs[..., :gamma]]                    # [N, R, gamma, V]
        p = p_table[prevs]                                 # [N, R, gamma+1, V]
        tokens, n = batched(drafts, q, p, _noise(method, N, K, gamma, V, gen))
        ncommit = n + 1
        src = torch.gather(tokens, 1,
                           torch.clamp(pos[None] - off[:, None], 0, gamma))
        write = (pos[None] >= off[:, None]) & (
            pos[None] < (off + ncommit)[:, None])
        buf = torch.where(write, src, buf)
        off = off + ncommit
        last = torch.gather(tokens, 1, n[:, None])[:, 0]
        ncommits.append(ncommit)
    return buf, off, torch.stack(ncommits, dim=1)


def ar_joint(p_table, s0: int, T: int) -> np.ndarray:
    """Analytic joint distribution of T autoregressive target tokens,
    flattened to shape [V**T] (float64)."""
    pt = np.asarray(p_table, dtype=np.float64)
    joint = pt[s0]
    for _ in range(T - 1):
        joint = np.einsum("...i,ij->...ij", joint, pt)
    return joint.reshape(-1)


def empirical_joint(tokens, V: int, T: int) -> np.ndarray:
    """Empirical joint of the first T committed tokens, shape [V**T]."""
    toks = np.asarray(tokens)[:, :T]
    flat = np.zeros(len(toks), dtype=np.int64)
    for j in range(T):
        flat = flat * V + toks[:, j]
    counts = np.bincount(flat, minlength=V ** T).astype(np.float64)
    return counts / counts.sum()


def tv_distance(a, b) -> float:
    return 0.5 * float(np.abs(np.asarray(a) - np.asarray(b)).sum())


def jax_tables(key, concentration: float = 0.6):
    """markov.random_tables(key) as float32 torch tensors."""
    q, p = markov.random_tables(key, V, concentration)
    return (torch.from_numpy(np.array(q, dtype=np.float32)),
            torch.from_numpy(np.array(p, dtype=np.float32)))


def run(method: str, K: int, seed: int = 0, concentration: float = 0.6,
        n_trials: int = N_TRIALS, striped: bool = False):
    """The JAX file's `_run`: tables from split(PRNGKey(seed))[0], s0 = 1,
    T blocks. Returns the empirical, target and draft joints of T tokens."""
    ktab, _ = jax.random.split(jax.random.PRNGKey(seed))
    q_table, p_table = jax_tables(ktab, concentration)
    bufs, counts, _ = spec_generate_markov(
        torch.Generator().manual_seed(1000 + seed), q_table, p_table, 1,
        n_trials, method=method, K=K, gamma=GAMMA, blocks=T, striped=striped)
    assert int(counts.min()) >= T, "each trial must commit at least T tokens"
    return (empirical_joint(bufs, V, T), ar_joint(p_table, 1, T),
            ar_joint(q_table, 1, T))
