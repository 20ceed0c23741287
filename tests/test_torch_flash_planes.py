"""The arithmetic of K8's tensor-core kernel (`csrc/flash_decode.cu`,
bf16 K/V) against the JAX package on the CPU.

The kernel cannot run here, so a plain-torch model of its order stands in:
* q as bf16 planes: the RoPE form rotates the raw q in f32 (`rope_rotate`)
  and splits it into hi, mid and lo with hi + mid + lo == q exactly; the
  scores are the planes' products summed;
* the chunk plan from S, Hkv and d (`chunk_for`), 64-key tiles, each tile's
  keys in two slices of 32; a slice runs its own online softmax over its
  keys of the chunk's tiles in order: scale, bias, the index mask, an
  explicit zero at invalid keys, p rounded to V's dtype for PV;
* the slices of a chunk merged in slice order, then the chunks combined in
  chunk order: M = max m, w = exp(m - M), l = sum l w, acc = sum acc w,
  acc / max(l, 1e-30).
The model is held against `_flash_core` (Pallas interpret mode, f32) within
the 1e-5 of `tests/test_torch_flash_decode.py::test_plain_matches_pallas`
at the draft (14/2/64, S 204), the verify (40/8/128, T 11), the tree with
its bias (32/8/128, T 60, S 189) and a 1100-slot cache (40/8/128, T 11,
S 1120), raw and with the RoPE form. The negative control, the roped q's
hi plane alone (one bf16 plane), must fail that limit. The plane split is
checked bit for bit on rotated queries, and the chunk plan on its inputs.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsd_tpu.ops.flash_decode as jfd
from hsd_tpu_torch.ops import flash_decode as tfd

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
KEY_TILE, SLICES = 64, 2
SLICE_KEYS = KEY_TILE // SLICES
# (label, T, H, Hkv, d, S, kv_len, start, bias)
SHAPES = [("draft", 1, 14, 2, 64, 204, 164, 3, False),
          ("verify", 11, 40, 8, 128, 204, 164, 3, False),
          ("tree", 60, 32, 8, 128, 189, 100, 0, True),
          ("long", 11, 40, 8, 128, 1120, 1056, 0, False)]


def _bf16(t):
    return t.to(torch.bfloat16).float()


def planes(x):
    """hi, mid, lo: bf16-valued f32 tensors with hi + mid + lo == x."""
    hi = _bf16(x)
    mid = _bf16(x - hi)
    return hi, mid, _bf16(x - hi - mid)


def _merge(parts):
    """(m, l, acc) parts of the same rows merged in order."""
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    L = A = None
    for m, l, acc in parts:
        w = torch.exp(m - M)
        L = l * w if L is None else L + l * w
        A = acc * w if A is None else A + acc * w
    return M, L, A


def kernel_model(q, k, v, q_index, start, kv_length, bias=None, rope=None,
                 n_planes=3):
    """The kernel's order (see the module docstring); returns [T, H, d]
    float32."""
    T, H, d = q.shape
    S, Hkv = k.shape[0], k.shape[1]
    rep = H // Hkv
    qf = q.float()
    if rope is not None:
        qf = tfd.rope_rotate(qf, rope)
    qp = [p.reshape(T, Hkv, rep, d).permute(1, 2, 0, 3)
          for p in planes(qf)[:n_planes]]                     # [Hkv, rep, T, d]
    kp = torch.arange(S)
    valid_all = ((kp[None] <= q_index.reshape(T, 1))
                 & (kp[None] >= int(start)))                   # [T, S]
    bias_all = torch.zeros((T, S))
    if bias is not None:
        hi = min(S, kv_length + T)
        bias_all[:, kv_length:hi] = bias[:, :hi - kv_length]
    scale = d ** -0.5
    chunk = tfd.chunk_for(S, Hkv, d)
    chunks = []
    for c0 in range(0, S, chunk):
        c1 = min(S, c0 + chunk)
        slices = []
        for sl in range(SLICES):
            m = torch.full((Hkv, rep, T, 1), tfd.NEG)
            l = torch.zeros((Hkv, rep, T, 1))
            acc = torch.zeros((Hkv, rep, T, d))
            for t0 in range(c0, c1, KEY_TILE):
                lo = t0 + SLICE_KEYS * sl
                hi = min(lo + SLICE_KEYS, c1)
                if lo >= hi:             # zero-filled and masked: no change
                    continue
                keys = torch.arange(lo, hi)
                kb = k[keys].float()
                sc = sum(torch.einsum("hrtd,shd->hrts", p, kb) for p in qp)
                sc = sc * scale + bias_all[:, keys]
                valid = valid_all[:, keys]
                sc = torch.where(valid, sc, tfd.NEG)
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.where(valid, torch.exp(sc - m_new), 0.0)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + torch.einsum(
                    "hrts,shd->hrtd", p.to(v.dtype).float(), v[keys].float())
                m = m_new
            slices.append((m, l, acc))
        chunks.append(_merge(slices))
    _, l, acc = _merge(chunks) if len(chunks) > 1 else chunks[0]
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(2, 0, 1, 3).reshape(T, H, d)


def _case(label, T, H, Hkv, d, S, kv_len, start, bias, rope):
    rng = np.random.default_rng(T * 7 + d + S + int(rope))
    q = rng.standard_normal((T, H, d)).astype(np.float32)
    k = rng.standard_normal((S, Hkv, d)).astype(np.float32)
    v = rng.standard_normal((S, Hkv, d)).astype(np.float32)
    qi = (kv_len + np.arange(T)).astype(np.int32)
    ab = None
    if bias:       # a trie mask: node i attends to its ancestor chain
        anc = np.tril(rng.random((T, T)) < 0.6)
        np.fill_diagonal(anc, True)
        ab = np.where(anc, 0.0, -1e30).astype(np.float32)
    jrope = trope = None
    if rope:
        ang = rng.standard_normal((T, d // 2)).astype(np.float32) * 3
        cos, sin = np.cos(ang), np.sin(ang)
        jrope = (jnp.asarray(cos), jnp.asarray(sin))
        trope = (torch.from_numpy(np.concatenate([cos, cos], -1)),
                 torch.from_numpy(np.concatenate([-sin, sin], -1)))
    want = np.asarray(jfd._flash_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qi),
        jnp.int32(start), jnp.int32(kv_len),
        None if ab is None else jnp.asarray(ab), rope=jrope, interpret=True))
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(qi).long(), torch.tensor([start]), kv_len,
            None if ab is None else torch.from_numpy(ab), trope)
    return want, args


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("rope", [False, True])
def test_kernel_order_matches_pallas(shape, rope):
    want, args = _case(*shape, rope)
    got = kernel_model(*args)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_one_plane_of_the_roped_q_fails():
    """Negative control: the RoPE form's f32 q as its hi plane alone."""
    want, args = _case(*SHAPES[1], True)
    got = kernel_model(*args, n_planes=1)
    assert not np.allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("d", [64, 128])
def test_plane_split_of_the_roped_q_is_exact(d):
    """hi + mid + lo == q bit for bit on bf16 queries rotated by
    `rope_rotate` (the kernel's raw q and its f32 rotation), each plane
    bf16-valued."""
    rng = np.random.default_rng(d)
    T, H = 64, 40
    q = torch.from_numpy(rng.standard_normal((T, H, d)).astype(np.float32)
                         * 4).to(torch.bfloat16)
    ang = rng.standard_normal((T, d // 2)).astype(np.float32) * 50
    cos, sin = np.cos(ang), np.sin(ang)
    rope = (torch.from_numpy(np.concatenate([cos, cos], -1)),
            torch.from_numpy(np.concatenate([-sin, sin], -1)))
    qr = tfd.rope_rotate(q.float(), rope)
    hi, mid, lo = planes(qr)
    for p in (hi, mid, lo):
        assert torch.equal(_bf16(p), p)
    assert torch.equal((hi + mid) + lo, qr)
    assert torch.count_nonzero(lo) > qr.numel() // 4   # all three planes work


def test_chunk_plan_depends_on_s_hkv_d_only():
    """`chunk_for(S, Hkv, d)`: no other input (never T or the row count);
    64-key multiples; at most MAX_CHUNKS chunks; a chunk for every key."""
    assert list(inspect.signature(tfd.chunk_for).parameters) == ["S", "Hkv",
                                                                 "d"]
    for S in (1, 63, 64, 65, 128, 189, 204, 1000, 1120, 2144, 4192, 33000):
        for Hkv in (1, 2, 4, 8, 16, 64):
            for d in (64, 128):
                c = tfd.chunk_for(S, Hkv, d)
                n = -(-S // c)
                assert c % KEY_TILE == 0 and c >= KEY_TILE
                assert 1 <= n <= tfd.MAX_CHUNKS
                assert (n - 1) * c < S <= n * c
