"""Rank bodies of the port's parallel tests (tests/test_torch_sharding.py,
test_torch_tp*.py, test_torch_pp.py, test_torch_sp.py,
test_torch_parallel_serving.py, test_torch_train_dp.py,
test_torch_parallel_cli.py).

`parallel.mesh.run_ranks` spawns one process a rank and imports each body
here by name, so this module imports torch and the port only: no JAX in
the ranks. The test files build the JAX side in their own process and
pass numpy / CPU tensors in. Every body returns CPU objects; each rank
caps its threads at one (run_ranks does)."""
from __future__ import annotations

import os

import torch

from hsd_tpu_torch.engine import make_autoregressive, make_generate
from hsd_tpu_torch.engine.kvcache import init_cache, rollback
from hsd_tpu_torch.models import transformer
from hsd_tpu_torch.parallel import mesh as M
from hsd_tpu_torch.parallel import pp as PP
from hsd_tpu_torch.parallel import sharding as SH
from hsd_tpu_torch.parallel import sp as SP
from hsd_tpu_torch.parallel import tp as TP


def _counts_since(fn):
    M.reset_collectives()
    out = fn()
    return out, M.collective_counts()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def collectives(dev, seed):
    """Every collective on a 1-D grid of the world: psum (f32 and bf16),
    the gather, ppermute along the ring and a broadcast."""
    world = torch.distributed.get_world_size()
    mesh = M.make_grid((world,), ("x",))
    ax = mesh["x"]
    M.reset_collectives()
    g = torch.Generator().manual_seed(seed + ax.index)
    x = torch.randn((3, 5), generator=g).to(dev)
    return dict(
        x=x,
        psum32=M.psum(x, ax),
        psum16=M.psum(x.to(torch.bfloat16), ax),
        gathered=M.all_gather(x, ax, dim=1),
        ring=M.ppermute(x, ax, [(i, (i + 1) % world) for i in range(world)]),
        bcast=M.broadcast_from(x, ax, world - 1),
        counts=M.collective_counts())


# ---------------------------------------------------------------------------
# tensor parallelism (and the GSPMD layout)
# ---------------------------------------------------------------------------

def tp_forward(dev, cfg, params, tokens, max_len, shape, layout="tp",
               feature_layers=None, steps=None):
    """The TP forward of `params` on a (data, model) grid: `layout` "tp"
    (shard_params_tp) or "gspmd" (shard_params, the batch split on data).
    steps: token slices to feed one after another (a prefill then
    appends); default the whole of `tokens` at once. Returns the gathered
    logits of every step, this rank's cache and the collectives."""
    mesh = M.make_mesh(*shape)
    if layout == "tp":
        local = TP.shard_params_tp(params, mesh)
    else:
        local = SH.shard_params(params, mesh,
                                expert_parallel=(layout == "gspmd_ep"))
        tokens = SH.shard_tree(tokens, ("data", None), mesh)
    cfg_l = SH.local_config(cfg, tp=shape[1])
    cache = init_cache(cfg_l, tokens.shape[0], max_len, dev)
    fwd = TP.make_tp_forward(cfg, params, mesh, feature_layers)
    outs = []
    M.reset_collectives()
    for a, b in (steps or [(0, tokens.shape[1])]):
        out = fwd(local, tokens[:, a:b].to(dev), cache)
        cache = out[1]
        outs.append(out[0])
    counts = M.collective_counts()
    return dict(logits=outs, k=cache.k, counts=counts,
                feats=out[2] if feature_layers is not None else None)


def tp_generate(dev, cfg_d, cfg_t, params_d, params_t, eng, prompt, n,
                seed, repeats=1, layout="tp"):
    """make_generate with the TP target (or the GSPMD layout's forward)
    on a 1 x world grid, `repeats` runs from one seed; the replicated
    draft on every rank."""
    world = torch.distributed.get_world_size()
    mesh = M.make_mesh(1, world)
    local = (TP.shard_params_tp(params_t, mesh) if layout == "tp"
             else SH.shard_params(params_t, mesh))
    fwd = TP.make_tp_target_forward(cfg_t, params_t, mesh)
    gen = make_generate(cfg_d, cfg_t, eng, target_forward=fwd,
                        target_cache_ops=TP.tp_cache_ops(cfg_t, mesh))
    out = []
    for _ in range(repeats):
        g = torch.Generator().manual_seed(seed)
        r = gen(params_d, local, prompt, n, g)
        out.append((r.tokens, r.length, r.ncommit))
    return out


def tp_autoregressive(dev, cfg, params, eng, prompt, n):
    world = torch.distributed.get_world_size()
    mesh = M.make_mesh(1, world)
    local = TP.shard_params_tp(params, mesh)
    ar = make_autoregressive(
        cfg, eng, model_forward=TP.make_tp_target_forward(cfg, params, mesh),
        cache_init=TP.tp_cache_ops(cfg, mesh)[0])
    return ar(local, prompt, n, None)


def tp_eagle_generate(dev, cfg_t, ecfg, params_t, params_e, eng, prompt, n,
                      mode, seed):
    from hsd_tpu_torch.engine.eagle_engine import (default_feature_layers,
                                                   make_eagle_generate)
    world = torch.distributed.get_world_size()
    mesh = M.make_mesh(1, world)
    local = TP.shard_params_tp(params_t, mesh)
    gen = make_eagle_generate(
        cfg_t, ecfg, eng, mode=mode,
        target_forward=TP.make_tp_eagle_forward(
            cfg_t, params_t, default_feature_layers(cfg_t), mesh),
        target_cache_init=TP.tp_cache_init(cfg_t, mesh))
    r = gen(local, params_e, prompt, n, torch.Generator().manual_seed(seed))
    return r.tokens, r.length


def tp_slot_engine(dev, cfg_d, cfg_t, params_d, params_t, eng, n_slots,
                   bucket, prompts, seed, layout, steps=1):
    """SlotEngine over a plain, TP or PP target on a world-wide grid, steps
    pool blocks a macro: ({rid: tokens}, refilled_total)."""
    from hsd_tpu_torch.engine.server import SlotEngine
    world = torch.distributed.get_world_size()
    if layout == "tp":
        mesh = M.make_mesh(1, world)
        local = TP.shard_params_tp(params_t, mesh)
        fwd = TP.make_tp_server_forward(cfg_t, params_t, mesh)
        ops = TP.tp_pool_cache_ops(cfg_t, mesh)
    else:
        mesh = PP.make_pp_mesh(world)
        local = PP.shard_params_pp(params_t, mesh)
        fwd = PP.make_pp_server_forward(cfg_t, params_t, mesh)
        ops = PP.pp_pool_cache_ops(cfg_t, mesh)
    se = SlotEngine(cfg_d, cfg_t, eng, n_slots=n_slots, bucket=bucket,
                    params_d=params_d, params_t=local, seed=seed,
                    target_forward=fwd, target_cache_ops=ops, device=dev,
                    steps_per_dispatch=steps)
    for rid, (p, mn) in enumerate(prompts):
        se.submit(rid, p, max_new=mn)
    done = se.run_all()
    return {r.rid: list(r.out_tokens) for r in done}, se.refilled_total


def tp_eagle_server(dev, cfg_t, ecfg, params_t, params_e, eng, n_slots,
                    bucket, prompts, mode, seed, steps=1):
    """EagleSlotEngine over the TP pool forward, steps pool blocks a macro:
    ({rid: tokens}, refilled_total)."""
    from hsd_tpu_torch.engine.eagle_engine import default_feature_layers
    from hsd_tpu_torch.engine.eagle_server import EagleSlotEngine
    world = torch.distributed.get_world_size()
    mesh = M.make_mesh(1, world)
    local = TP.shard_params_tp(params_t, mesh)
    se = EagleSlotEngine(
        cfg_t, ecfg, eng, n_slots=n_slots, bucket=bucket, params_t=local,
        params_e=params_e, mode=mode, seed=seed, device=dev,
        target_forward=TP.make_tp_eagle_pool_forward(
            cfg_t, params_t, default_feature_layers(cfg_t), mesh),
        target_cache_init=TP.tp_cache_init(cfg_t, mesh),
        steps_per_dispatch=steps)
    for rid, (p, mn) in enumerate(prompts):
        se.submit(rid, p, max_new=mn)
    done = se.run_all()
    return {r.rid: list(r.out_tokens) for r in done}, se.refilled_total


# ---------------------------------------------------------------------------
# pipeline parallelism
# ---------------------------------------------------------------------------

def pp_forward(dev, cfg, params, tokens, max_len, pp, tp=1):
    mesh = PP.make_pp_mesh(pp) if tp == 1 else PP.make_pp_tp_mesh(pp, tp)
    if tp == 1:
        local = PP.shard_params_pp(params, mesh)
        fwd = PP.make_pp_target_forward(cfg, params, mesh)
    else:
        local = PP.shard_params_pp_tp(params, mesh)
        fwd = PP.make_pp_tp_target_forward(cfg, params, mesh)
    init, _, _ = PP.pp_cache_ops(cfg, mesh)
    cache = init(tokens.shape[0], max_len,
                 torch.zeros(tokens.shape[0], dtype=torch.int64), dev)
    (logits, cache), counts = _counts_since(lambda: fwd(local, tokens, cache))
    return dict(logits=logits, k=cache.k, length=cache.length, counts=counts)


def pp_generate(dev, cfg_d, cfg_t, params_d, params_t, eng, prompt, n, seed,
                pp, tp=1):
    mesh = PP.make_pp_mesh(pp) if tp == 1 else PP.make_pp_tp_mesh(pp, tp)
    if tp == 1:
        local = PP.shard_params_pp(params_t, mesh)
        fwd = PP.make_pp_target_forward(cfg_t, params_t, mesh)
    else:
        local = PP.shard_params_pp_tp(params_t, mesh)
        fwd = PP.make_pp_tp_target_forward(cfg_t, params_t, mesh)
    gen = make_generate(cfg_d, cfg_t, eng, target_forward=fwd,
                        target_cache_ops=PP.pp_cache_ops(cfg_t, mesh))
    r = gen(params_d, local, prompt, n, torch.Generator().manual_seed(seed))
    return r.tokens, r.length


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------

def sp_prefill(dev, cfg, params, tokens, sp, total_slots=None, nxt=None):
    """The ring prefill; with total_slots, the gathered cache and the
    logits of one more token decoded from it."""
    mesh = SP.make_sp_mesh(sp)
    logits, cache = SP.make_sp_prefill(cfg, mesh)(params, tokens)
    out = dict(logits=M.all_gather(logits, mesh["sp"], dim=1), k=cache.k,
               length=cache.length)
    if total_slots is not None:
        full = SP.gather_cache(cache, total_slots, mesh["sp"])
        out["gathered_k"] = full.k.clone()     # the forward appends in place
        out["next_logits"], _ = transformer.forward(cfg, params, nxt, full)
    return out


def ring(dev, q, k, v):
    from hsd_tpu_torch.ops.ring_attention import ring_attention
    world = torch.distributed.get_world_size()
    mesh = M.make_grid((world,), ("sp",))
    ax = mesh["sp"]
    B, T = q.shape[:2]
    Tc = T // world
    sl = slice(ax.index * Tc, (ax.index + 1) * Tc)
    pos = (ax.index * Tc + torch.arange(Tc))[None].expand(B, Tc)
    out = ring_attention(q[:, sl], k[:, sl], v[:, sl], pos, ax)
    return M.all_gather(out, ax, dim=1)


# ---------------------------------------------------------------------------
# data parallelism and ZeRO
# ---------------------------------------------------------------------------

def train_steps(dev, cfg_t, ecfg, tc, params_t, params_e, batches, dp,
                zero, version=3, feature_layers=None):
    """`len(batches)` steps of the EAGLE-3 (or -1) trainer on a dp x 1
    grid, the global batch on every rank; replicated moments or ZeRO.
    Returns the metrics, the trained leaves and this rank's moment
    bytes."""
    from hsd_tpu_torch.train import eagle1, eagle3
    mesh = M.make_mesh(dp, 1)
    state = eagle3.init_train_state(params_e, tc,
                                    zero_mesh=mesh if zero else None)
    if version == 3:
        step = eagle3.make_train_step(cfg_t, ecfg, tc, feature_layers,
                                      zero_mesh=mesh)
    else:
        step = eagle1.make_eagle1_train_step(cfg_t, ecfg, tc, zero_mesh=mesh)
    metrics = []
    for ids, lm in batches:
        state, m = step(state, params_t, ids, lm)
        metrics.append({k: float(v) for k, v in m.items()})
    opt = state.opt
    moment = (opt.moment_bytes() if zero else
              sum(t.numel() * t.element_size() for st in opt.state.values()
                  for k, t in st.items() if k != "step"))
    leaves = {k: v.detach() for k, v in eagle3.trainable_leaves(state.params)}
    return dict(metrics=metrics, leaves=leaves, moment_bytes=moment,
                opt=state.opt.state_dict())


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def cli(dev, module, argv, env=None):
    """One rank of a CLI (`main(argv)`), as torchrun would run it: the
    process group is up, so `initialize_multihost` returns the rank."""
    import importlib
    os.environ.update(env or {})
    importlib.import_module(module).main(argv)
    return torch.distributed.get_rank()


def rollback_is_local(dev, cfg, tp):
    """KV rollback on a rank's shard issues no collective."""
    mesh = M.make_mesh(1, tp)
    cache = TP.tp_cache_ops(cfg, mesh)[0](
        2, 32, torch.zeros(2, dtype=torch.int64), dev)
    cache = cache.replace(length=10)
    (c, ), counts = _counts_since(lambda: (rollback(cache, 5),))
    return c.length, counts, tuple(c.k.shape)


def fake_mesh(shape, names, rank):
    """The Mesh that rank `rank` of a row-major grid builds, without
    process groups: enough for `shard_tree`, which only slices."""
    coords, r = [], rank
    for s in reversed(shape):
        coords.append(r % s)
        r //= s
    coords = coords[::-1]
    axes = []
    for a, name in enumerate(names):
        ranks = []
        for j in range(shape[a]):
            c = list(coords)
            c[a] = j
            rr = 0
            for ci, s in zip(c, shape):
                rr = rr * s + ci
            ranks.append(rr)
        axes.append(M.Axis(name, tuple(ranks), coords[a]))
    return M.Mesh(axes)


def batch(dev, calls):
    """Several bodies of this module one after another in one world (one
    spawn for a test file's cases): calls is [(name, args)]; returns their
    results in order."""
    return [globals()[name](dev, *args) for name, args in calls]
