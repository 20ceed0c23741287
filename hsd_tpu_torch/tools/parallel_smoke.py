"""Phase 19 of chip_smoke.py: the parallel layer (parallel/) on one card.

`run()` spawns the ranks twice with `parallel.run_ranks`: a world of 2
runs 19a-19e, building and freeing each model in turn, and a world of 4
runs 19f. The ranks share the one card, so their process group is gloo
(NCCL refuses two ranks on one device): gloo takes CUDA tensors in
all_reduce and broadcast, which is all the collectives use. Two
processes on one card share its SMs, so no time here is a speed-up.

  19a TP 2: the 14B-geometry packed-int4 target (unfused) on its Megatron
      shards; one 11-row verify after a 64-token prefill against rank 0's
      single-card forward of the same weights; greedy spec == greedy AR;
      hsd on 3 prompts; SlotEngine over the TP server forward, 4 pool
      blocks a macro step (the on-device refill through the shards'
      cache ops).
  19b PP 2: the same target in its fused layout, 24 layers a rank: the
      verify's logits and each stage's cache against the single-card
      forward bit for bit; hsd tokens == the single-card run's.
  19c SP 2: the ring prefill of a 4096-token prompt (2048 rows a rank)
      against the single-card prefill; the gathered cache, 16 greedy
      tokens; peak GiB a rank.
  19d the EAGLE pool over the 8B int8 target (unfused) under TP 2:
      EagleSlotEngine (hsd_ref), 12 requests through 8 slots in macro
      steps of 4 (the refill's merge on the kv-head shards); greedy EAGLE
      == greedy AR.
  19e DP 2 with ZeRO: the EAGLE-3 step at the published 8B width over the
      frozen int8 trunk, 1 x 512 a rank, against the single-rank 2 x 512
      steps: the losses and the parameters' update; moment bytes a rank.
  19f world 4: PP x TP 2 x 2 on the 14B target cut to 8 layers; expert
      parallelism on Mixtral-8x7B cut to 4 layers, 2 experts a rank.

Every rank returns its results, its launch counts over the phase's
counted runs and its peak GiB; `run()` checks that the ranks agree and
that each comparison holds, and raises otherwise.
"""
from __future__ import annotations

import dataclasses
import statistics
import time

import numpy as np
import torch

from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine import make_autoregressive, make_generate
from hsd_tpu_torch.engine.kvcache import init_cache
from hsd_tpu_torch.models import transformer
from hsd_tpu_torch.ops import launch_counts, reset_launches
from hsd_tpu_torch.ops.linear import QuantizedLinear
from hsd_tpu_torch.parallel import mesh as M
from hsd_tpu_torch.parallel import pp as PP
from hsd_tpu_torch.parallel import sp as SP
from hsd_tpu_torch.parallel import tp as TP

BUCKET, VERIFY, GAMMA = 64, 11, 10
TP_NEW, TP_PROMPTS = 32, 3               # 19a hsd (cut from 64 for time)
GREEDY_NEW, GREEDY_GAMMA = 64, 4         # 19a / 19d greedy spec vs AR
SERVE_SLOTS, SERVE_REQS, SERVE_NEW = 4, 8, 32
SERVE_MACRO = 4           # pool blocks a step: the macro's on-device refill
PP_NEW = 8                               # 19b hsd
SP_T, SP_GREEDY = 4096, 16               # 19c
EAGLE_SLOTS, EAGLE_REQS, EAGLE_NEW = 8, 12, 32   # more requests: refills
DP_B, DP_T, DP_STEPS = 2, 512, 3         # 19e: one 1 x 512 row a rank
# no warmup: every step moves the parameters by about lr an element
DP_TC = dict(steps=7, lr=1e-3, warmup_steps=0, total_steps=100)
W4_LAYERS, MIX_LAYERS = 8, 4             # 19f: cut from 48 and 32
# the predicted tolerances (PERF.md, written before the first run):
# the largest |logit difference| over the largest |logit| of the reference
TP_TOL = 2.0 ** -4        # 19a, 19f: psums round the bf16 partials apart
SP_TOL = 2.0 ** -4        # 19c bf16: f32 ring softmax against bf16 probs
SP_TOL_F32 = 2.0 ** -10   # 19c with f32 activations: summation order only
DP_LOSS_RTOL = 1e-2       # 19e: the loss against the single-rank step's
# 19e: |ZeRO's update - the single rank's| / |the single rank's update|
# over every trainable element (2-norms); an update left out reads 1, one
# with its sign flipped 2
DP_UPDATE_RTOL = 0.1


def _prompts(n, seed, length=BUCKET):
    return [((torch.arange(length) + 97 * i + seed) % 1000) + 10
            for i in range(n)]


def _counted(total, fn):
    """fn() with the launch counters zeroed before and added to `total`
    after (the phase's counted runs)."""
    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    for k, v in launch_counts().items():
        total[k] = total.get(k, 0) + v
    return out


def _empty():
    """Return the freed blocks to the card (the caller dropped its names
    first), so the next model of the phase fits beside the other rank's."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def _prefill_verify(fwd, params, cache, prompt, verify):
    """A 64-token prefill (no head) then the 11-row verify's logits."""
    _, cache = fwd(params, prompt[None], cache, skip_head=True)
    logits, cache = fwd(params, verify[None], cache)
    return logits, cache


def _single(cfg):
    return lambda p, t, c, skip_head=False: transformer.forward(
        cfg, p, t, c, skip_head=skip_head)


def _draft_and_target(cfg_s, cfg_b, dev, logit_scale):
    from hsd_tpu_torch.eval.synthetic import build_coupled_pair
    draft, pair = build_coupled_pair(0, cfg_s, cfg_b, lam=0.0,
                                     logit_scale=logit_scale, device=dev)
    return draft, pair.big


# ---------------------------------------------------------------------------
# world 2
# ---------------------------------------------------------------------------

def tp_phase(dev, spec, total):
    cfg_s, cfg_b = spec["cfg_s"], spec["cfg_b"]
    draft, big = _draft_and_target(cfg_s, cfg_b, dev, spec["logit_scale"])
    full = TP.unfuse_params(cfg_b, big)
    del big
    mesh = M.make_mesh(1, 2)
    rank = mesh[M.MODEL_AXIS].index
    local = TP.shard_params_tp(full, mesh)
    prompts = [p.to(dev) for p in _prompts(TP_PROMPTS, 0)]
    verify = (torch.arange(VERIFY, device=dev) * 31 + 7) % 1000 + 10
    out = {}
    S = BUCKET + GREEDY_NEW + GAMMA + 2
    if rank == 0:       # the single-card forward of the same weights
        out["ref"], _ = _prefill_verify(_single(cfg_b), full,
                                        init_cache(cfg_b, 1, S, dev),
                                        prompts[0], verify)
    del full
    _empty()
    fwd = TP.make_tp_target_forward(cfg_b, local, mesh)
    ops = TP.tp_cache_ops(cfg_b, mesh)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    c = ops[0](1, S, zero, dev)
    _, c = fwd(local, prompts[0][None], c, skip_head=True)
    M.reset_collectives()
    out["logits"], _ = fwd(local, verify[None], c)
    out["collectives"] = M.collective_counts()
    out["layers"] = cfg_b.num_layers
    del c

    eng0 = EngineConfig(verifier=VerifierConfig(method="greedy",
                                                gamma=GREEDY_GAMMA),
                        max_new_tokens=GREEDY_NEW, temperature=0.0)
    res = _counted(total, lambda: make_generate(
        cfg_s, cfg_b, eng0, target_forward=fwd, target_cache_ops=ops)(
        draft, local, prompts[0], BUCKET, None))
    ar, ar_len = _counted(total, lambda: make_autoregressive(
        cfg_b, eng0, model_forward=fwd, cache_init=ops[0])(
        local, prompts[0], BUCKET, None))
    out["greedy"] = res.tokens[BUCKET:res.length].tolist()
    out["ar"] = ar[BUCKET:ar_len].tolist()

    eng = EngineConfig(verifier=VerifierConfig(method="hsd", gamma=GAMMA),
                       max_new_tokens=TP_NEW)
    gen = make_generate(cfg_s, cfg_b, eng, target_forward=fwd,
                        target_cache_ops=ops)
    hsd, bes, toks, secs = [], [], 0, 0.0
    before = dict(total)
    for i, prompt in enumerate(prompts):
        g = torch.Generator(device=dev).manual_seed(100 + i)
        t0 = time.perf_counter()
        r = _counted(total, lambda: gen(draft, local, prompt, BUCKET, g))
        secs += time.perf_counter() - t0
        toks += r.ncommit
        hsd.append(r.tokens[BUCKET:r.length].tolist())
        bes.append(float((r.accepts[:r.blocks].float() + 1).mean()))
    out["hsd"] = dict(tokens=hsd, be=statistics.mean(bes), tok_s=toks / secs,
                      launches={k: total[k] - before.get(k, 0)
                                for k in total})

    from hsd_tpu_torch.engine.server import SlotEngine
    eng_s = dataclasses.replace(eng, max_new_tokens=SERVE_NEW)
    se = SlotEngine(cfg_s, cfg_b, eng_s, n_slots=SERVE_SLOTS, bucket=BUCKET,
                    params_d=draft, params_t=local, seed=0,
                    target_forward=TP.make_tp_server_forward(cfg_b, local,
                                                             mesh),
                    target_cache_ops=TP.tp_pool_cache_ops(cfg_b, mesh),
                    steps_per_dispatch=SERVE_MACRO, device=dev)
    for rid, p in enumerate(_prompts(SERVE_REQS, 5)):
        se.submit(rid, p[:40 + 3 * rid].tolist())
    t0 = time.perf_counter()
    done = _counted(total, se.run_all)
    out["serving"] = dict(
        streams={r.rid: list(r.out_tokens) for r in done},
        secs=time.perf_counter() - t0, be=se.stats()["block_efficiency"],
        refilled=se.refilled_total, pool_blocks=se.pool_blocks,
        steps=se.steps)
    del se, local, draft
    _empty()
    return out


def pp_phase(dev, spec, total):
    """19b and 19c: PP 2 on the fused layout, then the SP prefill."""
    cfg_s, cfg_b = spec["cfg_s"], spec["cfg_b"]
    draft, full = _draft_and_target(cfg_s, cfg_b, dev, spec["logit_scale"])
    mesh = PP.make_pp_mesh(2)
    s = mesh[PP.PIPE_AXIS].index
    L = cfg_b.num_layers // 2
    prompt = _prompts(1, 0)[0].to(dev)
    verify = (torch.arange(VERIFY, device=dev) * 31 + 7) % 1000 + 10
    S = BUCKET + PP_NEW + GAMMA + 2
    ref, ref_cache = _prefill_verify(_single(cfg_b), full,
                                     init_cache(cfg_b, 1, S, dev), prompt,
                                     verify)
    ref_k = ref_cache.k[s * L:(s + 1) * L].clone()
    ref_v = ref_cache.v[s * L:(s + 1) * L].clone()
    del ref_cache
    local = PP.shard_params_pp(full, mesh)
    fwd = PP.make_pp_target_forward(cfg_b, local, mesh)
    ops = PP.pp_cache_ops(cfg_b, mesh)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    M.reset_collectives()
    logits, c = _counted(total, lambda: _prefill_verify(
        fwd, local, ops[0](1, S, zero, dev), prompt, verify))
    out = dict(bit_equal=dict(
        logits=bool(torch.equal(logits, ref)),
        k=bool(torch.equal(c.k, ref_k)), v=bool(torch.equal(c.v, ref_v))),
        max_diff=(logits - ref).abs().max().item(),
        collectives=M.collective_counts())
    del c, ref_k, ref_v

    eng = EngineConfig(verifier=VerifierConfig(method="hsd", gamma=GAMMA),
                       max_new_tokens=PP_NEW)
    one = make_generate(cfg_s, cfg_b, eng)(
        draft, full, prompt, BUCKET, torch.Generator(device=dev).manual_seed(7))
    pp = _counted(total, lambda: make_generate(
        cfg_s, cfg_b, eng, target_forward=fwd, target_cache_ops=ops)(
        draft, local, prompt, BUCKET,
        torch.Generator(device=dev).manual_seed(7)))
    out["hsd"] = dict(pp=pp.tokens[:pp.length].tolist(),
                      single=one.tokens[:one.length].tolist())
    del local, draft
    _empty()
    out["sp"] = sp_phase(dev, cfg_b, full, total)
    del full
    _empty()
    return out


def _sp_vs_single(cfg, full, tokens, mesh, total, dev):
    """The ring prefill and the single-card prefill of `tokens` in cfg's
    activation dtype: (this rank's chunk of logits, the gathered cache,
    the single's logits and cache, the peak GiB of each)."""
    ax = mesh[SP.SP_AXIS]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logits, cache = _counted(
        total, lambda: SP.make_sp_prefill(cfg, mesh)(full, tokens))
    peak_sp = (torch.cuda.max_memory_allocated() - base) / 2**30
    gathered = SP.gather_cache(cache, SP_T + SP_GREEDY, ax)
    del cache
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    single = init_cache(cfg, 1, SP_T + SP_GREEDY, dev)
    ref, single = transformer.forward(cfg, full, tokens, single)
    peak_single = (torch.cuda.max_memory_allocated() - base) / 2**30
    return logits, gathered, ref, single, peak_sp, peak_single


def _tamed(params):
    """The trunk's codes with each layer product's scales over sqrt(in).
    The random trunk's activations grow layer by layer until its attention
    logits reach ~1e2 and attention picks one key: where two keys nearly
    tie, any rounding flips the pick, and the two prefills part at those
    positions (the first card runs: 2 of 4096 positions off by the
    logits' range in bf16, the cache 0.9% in f32). The head keeps its
    scales, so the logits keep their spread."""
    def t(w):
        if not isinstance(w, QuantizedLinear):
            return w
        return w._replace(scales=(w.scales.float() / w.din ** 0.5)
                          .to(w.scales.dtype))
    return params._replace(layers={k: t(v) for k, v in params.layers.items()})


def sp_phase(dev, cfg, full, total):
    """19c: the ring prefill against the single card's on the tamed trunk
    (`_tamed`), in the model's bf16 and with f32 activations (the same
    int4 weights, every product and the attention in f32, so only the
    summation order differs)."""
    full = _tamed(full)
    mesh = SP.make_sp_mesh(2)
    ax = mesh[SP.SP_AXIS]
    i, Tc = ax.index, SP_T // 2
    tokens = ((torch.arange(SP_T, device=dev) * 7919)
              % (cfg.vocab_size - 20) + 10)[None]
    logits, gathered, ref, single, peak_sp, peak_single = _sp_vs_single(
        cfg, full, tokens, mesh, total, dev)
    chunk = ref[:, i * Tc:(i + 1) * Tc]
    pos_err = ((logits - chunk).abs().amax(-1)
               / chunk.abs().amax(-1))[0].float()
    out = dict(
        bf16=dict(
            logits_rel_err=_rel_err(logits, chunk),
            cache_rel_err=_rel_err(gathered.k[:, :, :SP_T],
                                   single.k[:, :, :SP_T]),
            median_pos_err=float(pos_err.median()),
            pos_over=int((pos_err > SP_TOL).sum()),
            worst_pos=i * Tc + int(pos_err.argmax()),
            argmax_agree=float((logits.argmax(-1) == chunk.argmax(-1))
                               .float().mean())),
        length=gathered.length, peak_gib=peak_sp,
        single_peak_gib=peak_single)
    last = M.broadcast_from(logits[:, -1].contiguous(), ax, 1)
    ref_last = ref[:, -1].clone()
    del ref, chunk, logits, pos_err
    _empty()

    def greedy(cache, last):
        toks = []
        for _ in range(SP_GREEDY):
            nxt = torch.argmax(last, -1)[:, None]
            toks.append(int(nxt))
            lg, cache = transformer.forward(cfg, full, nxt, cache)
            last = lg[:, -1]
        return toks

    a, b = greedy(gathered, last), greedy(single, ref_last)
    out["greedy"] = dict(sp=a, single=b, common=_prefix(a, b))
    del gathered, single
    _empty()

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    logits, gathered, ref, single, _, _ = _sp_vs_single(
        cfg32, full, tokens, mesh, total, dev)
    out["f32"] = dict(
        logits_rel_err=_rel_err(logits, ref[:, i * Tc:(i + 1) * Tc]),
        cache_rel_err=_rel_err(gathered.k[:, :, :SP_T],
                               single.k[:, :, :SP_T]))
    del logits, gathered, ref, single
    _empty()
    return out


def eagle_phase(dev, spec, total):
    """19d: the EAGLE pool over the 8B int8 target under TP 2."""
    from hsd_tpu_torch.engine.eagle_engine import make_eagle_generate
    from hsd_tpu_torch.engine.eagle_server import EagleSlotEngine
    from hsd_tpu_torch.eval.synthetic import build_coupled_eagle_pair
    cfg, ecfg = spec["cfg_e"], spec["ecfg"]
    head, et = build_coupled_eagle_pair(0, cfg, ecfg, scale=6.0, lam=1.312,
                                        big_bits=8, device=dev)
    full = TP.unfuse_params(cfg, et.big)
    del et
    mesh = M.make_mesh(1, 2)
    local = TP.shard_params_tp(full, mesh)
    del full
    _empty()
    fwd = TP.make_tp_eagle_pool_forward(cfg, local, (-1,), mesh)
    init = TP.tp_cache_init(cfg, mesh)
    eng = EngineConfig(max_new_tokens=EAGLE_NEW, temperature=1.0)
    se = EagleSlotEngine(cfg, ecfg, eng, n_slots=EAGLE_SLOTS, bucket=BUCKET,
                         params_t=local, params_e=head, mode="hsd_ref",
                         seed=1, target_forward=fwd, target_cache_init=init,
                         steps_per_dispatch=4, device=dev)
    rng = np.random.default_rng(9)
    for rid in range(EAGLE_REQS):
        se.submit(rid, rng.integers(10, min(30000, cfg.vocab_size),
                                    int(rng.integers(32, 64))).tolist(),
                  max_new=EAGLE_NEW)
    before = dict(total)
    t0 = time.perf_counter()
    done = _counted(total, se.run_all)
    secs = time.perf_counter() - t0
    out = dict(streams={r.rid: list(r.out_tokens) for r in done}, secs=secs,
               be=se.stats()["block_efficiency"],
               refilled=se.refilled_total,
               launches={k: total[k] - before.get(k, 0) for k in total})
    eng0 = EngineConfig(max_new_tokens=EAGLE_NEW, temperature=0.0)
    prompt = _prompts(1, 3)[0].to(dev)
    res = _counted(total, lambda: make_eagle_generate(
        cfg, ecfg, eng0, mode="greedy", target_forward=fwd,
        target_cache_init=init)(local, head, prompt, BUCKET, None))
    ar, ar_len = _counted(total, lambda: make_autoregressive(
        cfg, eng0, model_forward=TP.make_tp_target_forward(cfg, local, mesh),
        cache_init=TP.tp_cache_ops(cfg, mesh)[0])(local, prompt, BUCKET,
                                                  None))
    out["greedy"] = res.tokens[BUCKET:res.length].tolist()
    out["ar"] = ar[BUCKET:ar_len].tolist()
    del se, local, head
    _empty()
    return out


def dp_phase(dev, spec, total):
    """19e: the EAGLE-3 step with ZeRO over DP 2 against one rank's."""
    from hsd_tpu_torch.engine.eagle_engine import default_feature_layers
    from hsd_tpu_torch.eval.synthetic import init_quantized_params
    from hsd_tpu_torch.models.eagle import init_eagle_params
    from hsd_tpu_torch.train import eagle3 as E3
    from hsd_tpu_torch.train.draft_vocab import build_draft_vocab, count_tokens
    cfg, ecfg = spec["cfg_e"], spec["ecfg3"]
    trunk = init_quantized_params(cfg, seed=0, bits=8, device=dev)
    rng = np.random.default_rng(19)
    ids = rng.integers(10, min(20000, cfg.vocab_size),
                       (DP_B, DP_T)).astype(np.int64)
    lm = np.ones((DP_B, DP_T), np.float32)
    lm[:, :DP_T // 16] = 0.0             # the prompt's positions
    lm[1, -100:] = 0.0                   # unequal shares of the mask
    d2t, t2d = build_draft_vocab(count_tokens([ids], cfg.vocab_size),
                                 ecfg.draft_vocab_size)
    head = init_eagle_params(ecfg, seed=18, device=dev)._replace(
        d2t=torch.from_numpy(d2t).long().to(dev),
        t2d=torch.from_numpy(t2d).to(dev))
    tc = E3.TrainConfig(**DP_TC)
    fl = default_feature_layers(cfg)
    mesh = M.make_mesh(2, 1)
    rank = mesh[M.DATA_AXIS].index
    zstate = E3.init_train_state(head, tc, zero_mesh=mesh)
    zstep = E3.make_train_step(cfg, ecfg, tc, fl, zero_mesh=mesh)
    losses, ms = [], []
    for _ in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zstate, m = _counted(total, lambda: zstep(zstate, trunk, ids, lm))
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
    out = dict(losses=losses, step_ms=ms,
               moment_bytes=zstate.opt.moment_bytes())
    if rank == 0:       # the single-rank step on the whole batch
        state = E3.init_train_state(head, tc)
        step = E3.make_train_step(cfg, ecfg, tc, fl)
        one = []
        for _ in range(DP_STEPS):
            state, m = step(state, trunk, ids, lm)
            one.append(float(m["loss"]))
        out["single_losses"] = one
        out["single_moment_bytes"] = sum(
            t.numel() * t.element_size() for st in state.opt.state.values()
            for k, t in st.items() if k != "step")
        out.update(_update_diff(E3, head, state.params, zstate.params))
        del state
    del zstate, trunk, head
    _empty()
    return out


@torch.no_grad()
def _update_diff(E3, init, single, zero):
    """How far ZeRO's update (its parameters less the initial ones) lies
    from the single rank's, over every trainable element: the 2-norm
    ratio, the largest |difference|, and the largest |single update| (what
    the largest difference reads when ZeRO leaves a parameter unmoved)."""
    p0 = dict(E3.trainable_leaves(init))
    pz = dict(E3.trainable_leaves(zero))
    num = den = big = diff = 0.0
    for k, v in E3.trainable_leaves(single):
        ds = v.float() - p0[k].float()
        dd = pz[k].float() - p0[k].float() - ds
        num += float((dd * dd).sum())
        den += float((ds * ds).sum())
        diff = max(diff, dd.abs().max().item())
        big = max(big, ds.abs().max().item())
    return dict(update_rel_err=(num / den) ** 0.5, param_max_diff=diff,
                update_max=big)


def world2(dev, spec):
    """19a-19e on one rank of the world of 2."""
    torch.backends.cuda.matmul.allow_tf32 = False
    total, out, secs = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    for name, fn in (("tp", tp_phase), ("pp", pp_phase),
                     ("eagle", eagle_phase), ("dp", dp_phase)):
        t0 = time.perf_counter()
        out[name] = fn(dev, spec, total)
        secs[name] = time.perf_counter() - t0
    out.update(launches=total, device=torch.cuda.get_device_name(dev),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, secs=secs)
    return out


# ---------------------------------------------------------------------------
# world 4
# ---------------------------------------------------------------------------

def world4(dev, spec):
    """19f on one rank of the world of 4."""
    from hsd_tpu_torch.eval.synthetic import init_quantized_params
    torch.backends.cuda.matmul.allow_tf32 = False
    total = {}
    torch.cuda.reset_peak_memory_stats()
    prompt = _prompts(1, 0)[0].to(dev)
    verify = (torch.arange(VERIFY, device=dev) * 31 + 7) % 1000 + 10
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    S = BUCKET + VERIFY
    out = {}
    rank = torch.distributed.get_rank()

    cfg = dataclasses.replace(spec["cfg_b"], num_layers=W4_LAYERS)
    full = TP.unfuse_params(cfg, init_quantized_params(cfg, seed=0, bits=4,
                                                       device=dev))
    if rank == 0:
        out["pptp_ref"], _ = _prefill_verify(
            _single(cfg), full, init_cache(cfg, 1, S, dev), prompt, verify)
    mesh = PP.make_pp_tp_mesh(2, 2)
    local = PP.shard_params_pp_tp(full, mesh)
    del full
    _empty()
    fwd = PP.make_pp_tp_target_forward(cfg, local, mesh)
    out["pptp"], _ = _counted(total, lambda: _prefill_verify(
        fwd, local, PP.pp_cache_ops(cfg, mesh)[0](1, S, zero, dev), prompt,
        verify))
    del local
    _empty()

    cfg = dataclasses.replace(spec["cfg_m"], num_layers=MIX_LAYERS)
    full = TP.unfuse_params(cfg, init_quantized_params(cfg, seed=0, bits=4,
                                                       device=dev))
    if rank == 0:
        out["moe_ref"], _ = _prefill_verify(
            _single(cfg), full, init_cache(cfg, 1, S, dev), prompt, verify)
    mesh = M.make_mesh(1, 4)
    local = TP.shard_params_tp(full, mesh)
    del full
    _empty()
    fwd = TP.make_tp_target_forward(cfg, local, mesh)
    before = dict(total)
    out["moe"], _ = _counted(total, lambda: _prefill_verify(
        fwd, local, TP.tp_cache_ops(cfg, mesh)[0](1, S, zero, dev), prompt,
        verify))
    out["moe_launches"] = {k: total[k] - before.get(k, 0) for k in total}
    out["experts_local"] = int(local.layers["wgate"].qweight.shape[1])
    del local
    _empty()
    out.update(launches=total, device=torch.cuda.get_device_name(dev),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return out


def send_recv_probe(dev):
    """Whether gloo takes a CUDA tensor in send / recv (PyTorch's backend
    table says it does not; the collectives above never ask it to):
    "works", or the error each rank gets (`run` reports a rank that gloo
    aborts instead)."""
    x = torch.arange(4.0, device=dev)
    try:
        if torch.distributed.get_rank() == 0:
            torch.distributed.send(x, dst=1)
        else:
            torch.distributed.recv(x, src=0)
        torch.cuda.synchronize()
        return "works"
    except Exception as e:      # the probe reports whatever gloo raises
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

def _same(label, values):
    if any(v != values[0] for v in values[1:]):
        raise AssertionError(f"{label}: the ranks disagree")


def _prefix(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def run(log, eagle3_config: dict, timeout: float = 900.0) -> dict:
    """Spawn the worlds of 2 and 4 on the card over gloo, check every
    comparison and that the ranks agree; returns the per-rank and summed
    launches and the numbers `log` printed."""
    from hsd_tpu_torch.models.eagle import EagleConfig
    from hsd_tpu_torch.tools import bench_main as BM
    cfg_e, ecfg = BM.eagle_configs()
    ecfg3 = EagleConfig(
        hidden_size=eagle3_config["hidden_size"],
        target_hidden_size=eagle3_config["hidden_size"],
        num_heads=eagle3_config["num_attention_heads"],
        num_kv_heads=eagle3_config["num_key_value_heads"],
        vocab_size=eagle3_config["vocab_size"],
        draft_vocab_size=eagle3_config["draft_vocab_size"],
        rms_norm_eps=eagle3_config["rms_norm_eps"],
        rope_theta=eagle3_config["rope_theta"],
        intermediate_size=eagle3_config["intermediate_size"])
    spec = dict(cfg_s=ModelConfig.qwen2_05b(), cfg_b=ModelConfig.qwen2_14b(),
                logit_scale=1.467, cfg_e=cfg_e, ecfg=ecfg, ecfg3=ecfg3,
                cfg_m=ModelConfig.mixtral_8x7b())
    log("parallel (19): backend gloo (the ranks share the one card; NCCL "
        "needs a card a rank), world 2 for 19a-19e, world 4 for 19f")
    try:
        probe = M.run_ranks(send_recv_probe, 2, backend="gloo",
                            device="cuda", timeout=90, pg_timeout=20)
    except (RuntimeError, TimeoutError) as e:
        # gloo may throw from its own thread and so abort the rank
        probe = "; ".join(ln for ln in str(e).splitlines()
                          if ln.startswith(("rank", "exit")))
    log(f"parallel (19): gloo send / recv of a CUDA tensor: {probe}; "
        f"all_reduce and broadcast carry every collective below")
    t0 = time.time()
    r2 = M.run_ranks(world2, 2, spec, backend="gloo", device="cuda",
                     timeout=timeout)
    secs2 = time.time() - t0
    check2(r2, log)
    t0 = time.time()
    r4 = M.run_ranks(world4, 4, spec, backend="gloo", device="cuda",
                     timeout=timeout)
    secs4 = time.time() - t0
    check4(r4, log)
    per_rank = [o["launches"] for o in r2] + [o["launches"] for o in r4]
    summed = {}
    for L in per_rank:
        for k, v in L.items():
            summed[k] = summed.get(k, 0) + v
    log(f"parallel (19): launches per rank (world 2, then world 4) "
        f"{per_rank}, summed {summed}; world 2 {secs2:.1f}s, world 4 "
        f"{secs4:.1f}s")
    return dict(launches=summed, per_rank=per_rank, secs2=secs2,
                secs4=secs4)


def check2(r2, log):
    """19a-19e's checks on the world of 2's results."""
    for r, o in enumerate(r2):
        log(f"parallel (19): world 2 rank {r} on {o['device']}, peak "
            f"{o['peak_gib']:.2f} GiB, launches {o['launches']}, seconds "
            + ", ".join(f"{k} {v:.1f}" for k, v in o["secs"].items()))

    # 19a
    a = [o["tp"] for o in r2]
    _same("19a verify logits", [x["logits"].tolist() for x in a])
    err = _rel_err(a[0]["logits"], a[0]["ref"])
    agree = int((a[0]["logits"].argmax(-1) == a[0]["ref"].argmax(-1)).sum())
    coll, want = a[0]["collectives"], dict(psum=2 * a[0]["layers"],
                                            all_gather=1, ppermute=0,
                                            broadcast=0)
    log(f"19a TP 2: the 11-row verify vs the single-card forward: max |diff| "
        f"/ max |logit| {err:.3e} (predicted <= {TP_TOL:.3e}), argmax agree "
        f"{agree}/{VERIFY}; collectives a forward {coll} (2 psums a layer + "
        f"1 logits gather: {2 * a[0]['layers'] + 1})")
    if not err <= TP_TOL:
        raise AssertionError(f"19a: TP logits {err} > {TP_TOL}")
    if coll != want:
        raise AssertionError(f"19a: collectives {coll}")
    _same("19a greedy", [(x["greedy"], x["ar"]) for x in a])
    log(f"19a greedy spec vs greedy AR under TP: {_prefix(a[0]['greedy'], a[0]['ar'])}"
        f" of {min(len(a[0]['greedy']), len(a[0]['ar']))} tokens agree")
    if a[0]["greedy"] != a[0]["ar"]:
        raise AssertionError("19a: greedy spec != greedy AR under TP")
    _same("19a hsd tokens", [x["hsd"]["tokens"] for x in a])
    h = a[0]["hsd"]
    log(f"19a hsd (gamma {GAMMA}, K 1) over TP on {TP_PROMPTS} prompts x "
        f"{TP_NEW} tokens: BE {h['be']:.4f} (an uncoupled random target: no "
        f"bar), {h['tok_s']:.2f} tok/s a rank (two ranks share the card: not "
        f"a speed-up); every rank's tokens equal; launches a rank "
        f"{h['launches']}")
    for x in a:
        L = x["hsd"]["launches"]
        if L["K3"] <= 0 or L["K4"] <= 0 or L["K1"] or L["K2"]:
            raise AssertionError(f"19a: launches {L}")
    _same("19a serving", [(x["serving"]["streams"], x["serving"]["refilled"])
                          for x in a])
    sv = a[0]["serving"]
    if sorted(sv["streams"]) != list(range(SERVE_REQS)):
        raise AssertionError("19a: serving lost a request")
    if sv["refilled"] <= 0:
        raise AssertionError("19a: no request took a slot inside a macro")
    log(f"19a SlotEngine over the TP server forward ({SERVE_SLOTS} slots, "
        f"{SERVE_REQS} requests x {SERVE_NEW}, {SERVE_MACRO} pool blocks a "
        f"macro step): every rank served the same streams, "
        f"{sum(map(len, sv['streams'].values()))} tokens in "
        f"{sv['secs']:.2f}s, {sv['pool_blocks']} pool blocks in "
        f"{sv['steps']} steps; refilled_total a rank "
        f"{[x['serving']['refilled'] for x in a]}")

    # 19b / 19c
    b = [o["pp"] for o in r2]
    for r, x in enumerate(b):
        log(f"19b PP 2 rank {r}: bit-equal to the single card {x['bit_equal']}"
            f" (max |diff| {x['max_diff']:.3e}); collectives {x['collectives']}")
        if not all(x["bit_equal"].values()):
            raise AssertionError(f"19b: rank {r} not bit-equal")
        if x["hsd"]["pp"] != x["hsd"]["single"]:
            raise AssertionError("19b: PP hsd tokens != the single card's")
    _same("19b hsd", [x["hsd"]["pp"] for x in b])
    log(f"19b PP hsd tokens == the single-card run on the same seed "
        f"({len(b[0]['hsd']['pp']) - BUCKET} tokens), every rank")
    c = [x["sp"] for x in b]
    for r, x in enumerate(c):
        h, f = x["bf16"], x["f32"]
        log(f"19c SP 2 rank {r}: {SP_T}-token prefill ({SP_T // 2} rows a "
            f"rank) of the tamed trunk against the single card's; f32 "
            f"activations: logits rel err {f['logits_rel_err']:.3e}, cache "
            f"{f['cache_rel_err']:.3e} (tol {SP_TOL_F32:.3e}); bf16: logits "
            f"{h['logits_rel_err']:.3e} (tol {SP_TOL:.3e}; median position "
            f"{h['median_pos_err']:.3e}, {h['pos_over']} positions over, the "
            f"worst at {h['worst_pos']}), cache {h['cache_rel_err']:.3e}, "
            f"argmax agree {h['argmax_agree']:.4f}; peak "
            f"{x['peak_gib']:.2f} GiB vs the single prefill's "
            f"{x['single_peak_gib']:.2f}; greedy after gather_cache: "
            f"{x['greedy']['common']} of {SP_GREEDY} tokens as the single "
            f"card's")
        if not (f["logits_rel_err"] <= SP_TOL_F32
                and f["cache_rel_err"] <= SP_TOL_F32
                and h["logits_rel_err"] <= SP_TOL
                and h["cache_rel_err"] <= SP_TOL and x["length"] == SP_T):
            raise AssertionError(f"19c: rank {r} out of tolerance")
    _same("19c greedy", [x["greedy"]["sp"] for x in c])

    # 19d
    d = [o["eagle"] for o in r2]
    _same("19d serving", [(x["streams"], x["refilled"]) for x in d])
    _same("19d greedy", [(x["greedy"], x["ar"]) for x in d])
    log(f"19d EagleSlotEngine over TP 2 ({EAGLE_SLOTS} slots, {EAGLE_REQS} "
        f"requests x {EAGLE_NEW}, hsd_ref): every rank the same streams, "
        f"{d[0]['secs']:.2f}s, refilled_total a rank "
        f"{[x['refilled'] for x in d]}, launches a rank "
        f"{d[0]['launches']}; greedy "
        f"EAGLE vs AR under TP: {_prefix(d[0]['greedy'], d[0]['ar'])} of "
        f"{min(len(d[0]['greedy']), len(d[0]['ar']))} agree")
    if sorted(d[0]["streams"]) != list(range(EAGLE_REQS)):
        raise AssertionError("19d: serving lost a request")
    if d[0]["refilled"] <= 0:
        raise AssertionError("19d: no request took a slot inside a macro")
    if d[0]["launches"]["K7"] <= 0:
        raise AssertionError("19d: K7 never launched")
    if d[0]["greedy"] != d[0]["ar"]:
        raise AssertionError("19d: greedy EAGLE != AR under TP")

    # 19e
    e = [o["dp"] for o in r2]
    _same("19e losses", [x["losses"] for x in e])
    e0 = e[0]
    loss_rel = max(abs(x - y) / max(abs(y), 1e-30) for x, y in
                   zip(e0["losses"], e0["single_losses"]))
    ratio = e0["moment_bytes"] / e0["single_moment_bytes"]
    log(f"19e DP 2 + ZeRO, EAGLE-3 at 8B width, {DP_B} x {DP_T} (1 x {DP_T}"
        f" a rank), {DP_STEPS} steps at lr {DP_TC['lr']}: losses "
        f"{e0['losses']} vs one rank's {e0['single_losses']} (rel "
        f"{loss_rel:.2e}, tol {DP_LOSS_RTOL}); the update vs one rank's: "
        f"|diff| / |update| {e0['update_rel_err']:.3e} (tol "
        f"{DP_UPDATE_RTOL}; an update left out reads 1), max |diff| "
        f"{e0['param_max_diff']:.3e} (max |update| {e0['update_max']:.3e});"
        f" Adam moments {e0['moment_bytes'] / 2**30:.3f} GiB a rank, "
        f"{ratio:.4f} of the replicated "
        f"{e0['single_moment_bytes'] / 2**30:.3f}; step ms "
        f"{[round(x, 2) for x in e0['step_ms']]}")
    if not (loss_rel <= DP_LOSS_RTOL
            and e0["update_rel_err"] <= DP_UPDATE_RTOL
            and abs(ratio - 0.5) <= 0.05):
        raise AssertionError("19e: DP / ZeRO out of tolerance")


def check4(r4, log):
    """19f's checks on the world of 4's results."""
    for r, o in enumerate(r4):
        log(f"parallel (19): world 4 rank {r} on {o['device']}, peak "
            f"{o['peak_gib']:.2f} GiB, launches {o['launches']}")
    _same("19f pptp", [o["pptp"].tolist() for o in r4])
    _same("19f moe", [o["moe"].tolist() for o in r4])
    f_pt = _rel_err(r4[0]["pptp"], r4[0]["pptp_ref"])
    f_moe = _rel_err(r4[0]["moe"], r4[0]["moe_ref"])
    log(f"19f world 4: PP x TP 2 x 2 on the 14B target cut to {W4_LAYERS} "
        f"layers, rel err {f_pt:.3e}; Mixtral-8x7B cut to {MIX_LAYERS} "
        f"layers, {r4[0]['experts_local']} experts a rank x tp 4, rel err "
        f"{f_moe:.3e} (predicted <= {TP_TOL:.3e}); its launches a rank "
        f"{r4[0]['moe_launches']}")
    if not (f_pt <= TP_TOL and f_moe <= TP_TOL):
        raise AssertionError("19f: out of tolerance")
    if r4[0]["moe_launches"]["K3"] <= 0:
        raise AssertionError("19f: K3 never launched at the expert shapes")
