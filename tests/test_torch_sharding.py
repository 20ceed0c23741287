"""The port's sharding layer and collectives against the JAX package's
GSPMD layout (the cases of tests/test_sharding.py).

* The spec trees of `param_specs` (dense, MoE with and without expert
  parallelism, quantized) and `cache_specs` equal JAX's PartitionSpecs.
* Every rank's local shard of every leaf equals JAX's
  `addressable_shards[i]` for device i of the (2, 4) mesh, bit for bit;
  an in-sharded packed-int4 weight equals the logical slice packed again
  within the shard.
* The sharded forward (2 x 2 ranks, gloo, the batch split on `data`), the
  sharded generate and the packed-int4 forward against JAX's
  single-device forward within the JAX file's 2e-4; KV rollback issues no
  collective; the collective counter in place of the HLO all-gather
  check; the single-process helpers; every collective's bits equal on
  every rank; `compact_path_batched` == JAX's.
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
from hsd_tpu.engine import kvcache as jkv
from hsd_tpu.models import init_params as j_init_params
from hsd_tpu.models import transformer as jtr
from hsd_tpu.ops.linear import quantize as j_quantize
from hsd_tpu.parallel import make_mesh as j_make_mesh
from hsd_tpu.parallel import param_specs as j_param_specs
from hsd_tpu.parallel import cache_specs as j_cache_specs
from hsd_tpu.parallel import shard_params as j_shard_params
from hsd_tpu.parallel import pp as jpp
from hsd_tpu.parallel import tp as jtp
from hsd_tpu_torch import bridge
from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine import make_generate
from hsd_tpu_torch.engine.kvcache import KVCache, compact_path_batched
from hsd_tpu_torch.ops.linear import pack_int4, unpack_int4
from hsd_tpu_torch.parallel import pp as PP
from hsd_tpu_torch.parallel import tp as TP
from hsd_tpu_torch.parallel import (cache_specs, initialize_multihost,
                                    make_global_mesh, param_specs, run_ranks,
                                    shard_for_process, shard_params)

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)     # the JAX file's sharded-forward bound
JCFG = JCfg.tiny(vocab_size=256, num_heads=8, num_kv_heads=4,
                 hidden_size=64, intermediate_size=128)


def _tcfg(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "head_dim", "rope_theta",
        "rms_norm_eps", "tie_word_embeddings", "attention_bias",
        "eos_token_id", "num_experts", "num_experts_per_tok")},
        dtype=torch.float32)


CFG = _tcfg(JCFG)


def _spec_tuples(tree):
    """JAX spec tree -> the port's tuple specs (a P is a tuple of names)."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree).__name__, tuple(_spec_tuples(getattr(tree, f))
                                          for f in tree._fields)
    if isinstance(tree, dict):
        return {k: _spec_tuples(v) for k, v in tree.items()}
    return tuple(tree)


def _quantized(jp, bits, gs):
    q = {}
    for k, v in jp.layers.items():
        if k.startswith("w"):
            q[k] = jax.tree.map(lambda *xs: jnp.stack(xs),
                                *[j_quantize(v[i], bits=bits, group_size=gs)
                                  for i in range(v.shape[0])])
        else:
            q[k] = v
    return jp._replace(layers=q)


@pytest.mark.parametrize("layout", ["gspmd", "tp", "pp", "pp_tp"])
@pytest.mark.parametrize("case", ["dense", "moe", "moe_ep", "int8", "int4"])
def test_specs_match_jax(case, layout):
    """param_specs (GSPMD), tp_param_specs, pp_param_specs and
    pp_tp_param_specs == the JAX package's, and each layout's cache
    specs."""
    if case.startswith("moe"):
        jcfg = JCfg.tiny_moe(vocab_size=256, num_heads=8, num_kv_heads=4,
                             hidden_size=64, intermediate_size=96,
                             num_experts=4)
    else:
        jcfg = dataclasses.replace(JCFG, tie_word_embeddings=False)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    if case in ("int8", "int4"):
        jp = _quantized(jp, 8 if case == "int8" else 4, 16)
    ep = case == "moe_ep"
    tp = bridge.params_from_jax(jp)
    if layout == "gspmd":
        want = j_param_specs(jp, expert_parallel=ep)
        got = param_specs(tp, expert_parallel=ep)
        jc, c = j_cache_specs(), cache_specs()
    else:
        jmod = {"tp": jtp, "pp": jpp, "pp_tp": jpp}[layout]
        tmod = {"tp": TP, "pp": PP, "pp_tp": PP}[layout]
        want = getattr(jmod, f"{layout}_param_specs")(jp)
        got = getattr(tmod, f"{layout}_param_specs")(tp)
        name = {"tp": "cache_specs", "pp": "pp_cache_specs",
                "pp_tp": "pp_tp_cache_specs"}[layout]
        jc = (j_cache_specs() if layout == "tp" else getattr(jpp, name)())
        c = (cache_specs() if layout == "tp" else getattr(PP, name)())
    assert _spec_tuples(got) == _spec_tuples(want)
    # JAX's short specs (P("pipe")) name the leading dims only
    pad = lambda p, n: tuple(p) + (None,) * (n - len(tuple(p)))
    assert (c.k, c.v, c.start) == (pad(jc.k, 5), pad(jc.v, 5),
                                   tuple(jc.start))


def _leaves(tree, path=()):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), path + (f,))
    else:
        yield path, tree


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_local_shards_match_jax_addressable_shards(bits):
    """Rank r's shard of every leaf == JAX's shard on device r of the
    (data 2, model 4) mesh; packed int4 on its in axis == the logical
    slice re-packed within the shard."""
    jcfg = dataclasses.replace(JCFG, tie_word_embeddings=False)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    if bits:
        jp = _quantized(jp, bits, 16)
    tp = bridge.params_from_jax(jp)
    mesh = j_make_mesh(data=2, model=4)
    with jax.set_mesh(mesh):
        sp = j_shard_params(jp, mesh)
    jleaves = dict(_leaves(sp))
    tleaves = dict(_leaves(tp))
    for r in range(8):
        local = dict(_leaves(shard_params(
            tp, R.fake_mesh((2, 4), ("data", "model"), r))))
        assert local.keys() == jleaves.keys()
        for path, arr in jleaves.items():
            shard = next(s for s in arr.addressable_shards
                         if s.device.id == mesh.devices.flat[r].id)
            got = local[path].numpy()
            in_packed = (bits == 4 and path[-1] == "qweight"
                         and path[-2] in ("wo", "wdown"))
            if in_packed:
                # the logical rows of model index m, packed in the shard
                m = r % 4
                codes = torch.stack([unpack_int4(q) for q in tleaves[path]])
                n = codes.shape[1] // 4
                want = torch.stack([pack_int4(c[m * n:(m + 1) * n])
                                    for c in codes]).numpy()
                np.testing.assert_array_equal(got, want)
                # JAX's own shard is the packed-row chunk: a different set
                # of logical rows
                assert not np.array_equal(got, np.asarray(shard.data))
            else:
                np.testing.assert_array_equal(got, np.asarray(shard.data))


def _j_ref(jp, toks, S=16):
    return jax.jit(lambda p, t, c: jtr.forward(JCFG, p, t, c))(
        jp, toks, j_init_cache(JCFG, toks.shape[0], S))


TOKS = np.asarray((np.arange(12) % 50).reshape(2, 6) + 1, np.int32)
GEN_ENG = EngineConfig(verifier=VerifierConfig(method="hsd", gamma=3,
                                               num_drafts=2),
                       max_new_tokens=8)


def _forward_params(bits):
    jp = j_init_params(JCFG, jax.random.PRNGKey(0))
    return _quantized(jp, 4, 16) if bits else jp


@pytest.fixture(scope="module")
def world4():
    """The world-of-4 cases in one spawn: the GSPMD forward dense and
    packed int4 at (data 2, model 2), and the collectives."""
    toks = torch.from_numpy(TOKS).long()
    calls = [("tp_forward", (CFG, bridge.params_from_jax(_forward_params(b)),
                             toks, 16, (2, 2), "gspmd")) for b in (0, 4)]
    calls.append(("collectives", (11,)))
    res = run_ranks(R.batch, 4, calls, device="cpu")
    return {0: [r[0] for r in res], 4: [r[1] for r in res],
            "collectives": [r[2] for r in res]}


@pytest.fixture(scope="module")
def world2():
    """The world-of-2 cases in one spawn: generate, rollback, the
    collectives."""
    pd = bridge.params_from_jax(j_init_params(JCFG, jax.random.PRNGKey(0)))
    pt = bridge.params_from_jax(j_init_params(JCFG, jax.random.PRNGKey(1)))
    prompt = torch.arange(8) % 50 + 1
    calls = [("tp_generate", (CFG, CFG, pd, pt, GEN_ENG, prompt, 8, 3, 1,
                              "gspmd")),
             ("rollback_is_local", (CFG, 2)), ("collectives", (11,))]
    res = run_ranks(R.batch, 2, calls, device="cpu")
    return dict(generate=[r[0] for r in res], rollback=[r[1] for r in res],
                collectives=[r[2] for r in res], params=(pd, pt, prompt))


@pytest.mark.parametrize("bits", [0, 4])
def test_sharded_forward_matches_single(world4, bits):
    """The GSPMD layout on 2 x 2 gloo ranks (the batch on `data`, heads,
    ffn, vocab and the embedding on `model`) == JAX's single-device
    forward; the vocab-sharded embedding's lookup and the logits' gather
    counted. bits 4: packed int4 at group 16 (the JAX file's
    test_sharded_forward_packed_int4)."""
    ref, ref_cache = _j_ref(_forward_params(bits), jnp.asarray(TOKS))
    res = world4[bits]
    ref, rk = np.asarray(ref), np.asarray(ref_cache.k)
    for r, out in enumerate(res):
        d, m = divmod(r, 2)
        np.testing.assert_allclose(out["logits"][0].numpy(), ref[d:d + 1],
                                   **TOL)
        np.testing.assert_allclose(out["k"].numpy(),
                                   rk[:, d:d + 1, :, 2 * m:2 * m + 2], **TOL)
        # per forward: the embedding's psum, 2 psums a layer, one gather
        assert out["counts"] == dict(psum=1 + 2 * CFG.num_layers,
                                     all_gather=1, ppermute=0, broadcast=0)
    for d in range(2):       # the two model ranks of a row agree bitwise
        assert torch.equal(res[2 * d]["logits"][0],
                           res[2 * d + 1]["logits"][0])


def test_sharded_generate_runs(world2):
    """hsd generate (K 2) with the GSPMD-layout target on 2 ranks: the
    ranks commit the same tokens, and those of the single-card port run
    on the same generator."""
    pd, pt, prompt = world2["params"]
    one = make_generate(CFG, CFG, GEN_ENG)(pd, pt, prompt, 8,
                                           torch.Generator().manual_seed(3))
    (t0, l0, n0), = world2["generate"][0]
    (t1, l1, n1), = world2["generate"][1]
    assert n0 >= 1 and l0 == l1 and torch.equal(t0, t1)
    n = min(l0, one.length)
    agree = (t0[:n] == one.tokens[:n]).float().mean().item()
    assert agree > 0.9, agree


def test_sharded_kv_rollback_is_local(world2):
    """Rollback on a rank's kv-head shard issues no collective."""
    for length, counts, shape in world2["rollback"]:
        assert length == 5 and not any(counts.values())
        assert shape[3] == CFG.num_kv_heads // 2


def test_multihost_helpers_single_process():
    assert initialize_multihost() == 0
    assert make_global_mesh(model=1).size == 1
    items = list(range(11))
    parts = [shard_for_process(items, i, 3) for i in range(3)]
    assert sum(parts, []) == items
    assert shard_for_process(items) == items


@pytest.mark.parametrize("local_world,cards,ok", [
    (8, 8, True),       # 2 hosts x 8 cards: every rank has its own card
    (None, 8, False),   # no LOCAL_WORLD_SIZE: all 16 ranks on this host
    (4, 2, False)])
def test_initialize_multihost_checks_cards_per_host(monkeypatch, local_world,
                                                    cards, ok):
    """NCCL needs a card for each rank of THIS host: a world of 16 over
    hosts of 8 cards starts; more ranks on a host than its cards raise."""
    calls = []
    monkeypatch.setenv("WORLD_SIZE", "16")
    monkeypatch.setenv("LOCAL_RANK", "5")
    if local_world is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("card", d)))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 13)
    if ok:
        assert initialize_multihost() == 13
        assert calls == [("card", 5), ("nccl", {"init_method": "env://"})]
    else:
        with pytest.raises(ValueError, match="a card per rank"):
            initialize_multihost()
        assert ("nccl", {"init_method": "env://"}) not in calls


@pytest.mark.parametrize("layout", ["gspmd", "tp", "pp", "pp_tp"])
def test_shards_own_their_storage(layout):
    """Every split leaf of a rank's shard (packed int4) holds storage of
    its own size, not a view into the full model: dropping the full model
    frees it. A chunk on dim 0 (PP's layer stacks, the vocab-sharded
    embedding) is contiguous as a view, so this needs a copy."""
    jp = _quantized(j_init_params(dataclasses.replace(
        JCFG, tie_word_embeddings=False), jax.random.PRNGKey(0)), 4, 16)
    full = bridge.params_from_jax(jp)
    if layout == "gspmd":
        local = shard_params(full, R.fake_mesh((2, 4), ("data", "model"), 5))
    elif layout == "tp":
        local = TP.shard_params_tp(full, R.fake_mesh((1, 2),
                                                     ("data", "model"), 1))
    elif layout == "pp":
        local = PP.shard_params_pp(full, R.fake_mesh((2,), (PP.PIPE_AXIS,),
                                                     1))
    else:
        local = PP.shard_params_pp_tp(
            full, R.fake_mesh((2, 2), (PP.PIPE_AXIS, "model"), 3))
    whole = dict(_leaves(full))
    split = 0
    for path, t in _leaves(local):
        if t.shape == whole[path].shape:
            continue
        split += 1
        assert (t.untyped_storage().nbytes()
                == t.numel() * t.element_size()), path
        assert (t.untyped_storage().data_ptr()
                != whole[path].untyped_storage().data_ptr()), path
    assert split >= 4


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_exact_and_equal_on_every_rank(world, request):
    """psum leaves the same bits on every rank (f32 and bf16), within an
    f32 rounding of the exact sum; the gather, ppermute and the broadcast
    are exact copies; one count a call."""
    res = request.getfixturevalue(f"world{world}")["collectives"]
    xs = [r["x"] for r in res]
    exact = torch.stack([x.double() for x in xs]).sum(0)
    for r, out in enumerate(res):
        assert torch.equal(out["psum32"], res[0]["psum32"])
        assert torch.equal(out["psum16"], res[0]["psum16"])
        np.testing.assert_allclose(out["psum32"].double(), exact, rtol=1e-6)
        assert torch.equal(out["gathered"], torch.cat(xs, 1))
        assert torch.equal(out["ring"], xs[(r - 1) % world])
        assert torch.equal(out["bcast"], xs[-1])
        assert out["counts"] == dict(psum=2, all_gather=1, ppermute=1,
                                     broadcast=1)


def test_compact_path_batched_matches_jax():
    rng = np.random.default_rng(0)
    L, B, S, H, D, T = 2, 3, 24, 2, 4, 5
    k = rng.normal(size=(L, B, S, H, D)).astype(np.float32)
    v = rng.normal(size=(L, B, S, H, D)).astype(np.float32)
    rel = np.array([[0, 2, 3, -1, -1], [1, 4, -1, -1, -1],
                    [0, 1, 2, 3, 4]], np.int32)
    n_valid = np.array([3, 2, 5], np.int32)
    base = np.array([4, 10, 15], np.int32)
    jc = jkv.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                     length=jnp.int32(0), start=jnp.zeros((B,), jnp.int32))
    want = jkv.compact_path_batched(jc, jnp.asarray(rel), jnp.asarray(n_valid),
                                    jnp.asarray(base))
    tc = KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()),
                 length=0, start=torch.zeros(B, dtype=torch.int64))
    got = compact_path_batched(tc, torch.from_numpy(rel).long(),
                               torch.from_numpy(n_valid).long(),
                               torch.from_numpy(base).long())
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
