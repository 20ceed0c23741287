#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--trace]

Phases (any failure exits nonzero, with no result line):
  1. card      the card's name and power limit (nvidia-smi)
  2. build     hsd_tpu_torch/csrc/*.cu compiled for sm_90a at first use
  3. weights   the coupled pair of the speculative-decoding benchmark built
               on the card from a seed: a 48-layer 14B-geometry packed-int4
               target (int8 embedding, int4 head) summed with the bf16 0.5B
               trunk, and the asymmetric-int8 0.5B draft (logit_scale 1.467,
               lam 0)
  4. kernels   K1-K4 at the main path's shapes (K1 and K3 at 1, 11, 63, 121
               and 128 rows; K4, the draft's asymmetric int8, at 1, 2, 62
               and 64 rows; K2, the fused int4 layer tail, at 1, 7, 11 and
               32 rows) against their plain PyTorch versions (max error
               within 2^-7 of the output's max magnitude: two bf16
               roundings), timed with CUDA events over distinct layers so
               the weights stream from device memory, beside the plain
               version, one bf16 torch.matmul against the pre-dequantized
               weight, and the bound: the larger of bytes over 3.35 TB/s
               and operations over the 989 TFLOP/s bf16 tensor-core rate;
               a row's bits at 1, 11, 63 and 121 vs 128 rows (K1, K3) and
               at 1, 7 and 11 vs 32 rows (K2);
               route A, the dequantize-then-dot route of apply_linear above
               128 rows, at 200 and 693 rows on the 14B wqkv with the norm
               and wdown: no kernel launches, within 2^-7 of the f32 plain
               version, timed, with the memory it allocates
  4a. attention K8 (flash-decode) at the shapes of the paths below (14B
               verify, 0.5B draft, 8B EAGLE tree with its bias and prefill
               with a zero bias, long-context decode), with q rotated
               before and with the RoPE inside the kernel, against its plain
               version; a query row's bits at T = 1 and T = 11; timed as in
               phase 4 beside F.scaled_dot_product_attention with the same
               mask; bound: the K and V bytes of the cache over 3.35 TB/s
  4b. mlp      K6 (the fused SwiGLU MLP) through its route, apply_mlp on the
               14B target's 48 layers at 1 and 11 rows, with the launch
               counters zeroed before and read after (one K6 launch a call,
               nothing else), each call against its plain version; timed
               through the same route, beside two bf16 matmuls and the
               SwiGLU on the pre-dequantized weights; K6 at 7 and 32 rows
               vs plain, and a row's bits at 1, 7 and 11 vs 32 rows
  5. main path make_generate with hsd and tokenwise (gamma 10, K 1) on 3
               prompts of bucket 64, 128 new tokens each, with the launch
               counters zeroed before and read after (K8 must not launch:
               its routes are opt-in); AR over 32 tokens.
               With --trace, also a profiled 56-token hsd generate (device
               time by kernel, idle share), the same with FUSED_ATTN on, and
               the host cost of one K4 and one K2 call
  5c. opted in hsd on the first prompt, 128 new tokens, with K8 off (phase
               5's run again), with FUSED_ATTN = "always" and with
               FLASH_DECODE = "always", in turns (off, fused, flash, flash,
               fused, off): K8 must launch in the last two routes, a route's
               repeat must give its BE again; the BE is printed beside phase
               5's, and each route's mean ms per block
  5d. engines  stepwise, recursive, streaming (whose chunks must
               concatenate to make_generate's stream) and prompt lookup on
               the 48-layer 14B int4 trunk with the 0.5B int8 draft, gamma
               4, one 64-token prompt and 64 new tokens each, FUSED_ATTN on
  5e. long context  ms per decode step of the 14B int4 trunk at caches of
               1056, 2080 and 4128 tokens, T = 1 and 11, by the einsum path
               and by K8 (FLASH_DECODE = "always"), in turns
  5f. striped  make_generate with the striped multidraft layout
               (parallel=False, K 2: R = 11 rows), gamma 10, on phase 5's
               pair: hsd, tokenwise and hsd_ref, one 64-token prompt and 64
               new tokens each, with the launch counters zeroed before and
               read after (K1, K3 and K4 must launch, K8 must not); tokens
               in range, accepts in [0, gamma]; after one striped draft
               block on the 11-row draft cache, every mirrored row's
               entries before its activation step bitwise row 0's; hsd_ref
               run twice with one seed gives identical streams
  5g. serving  SlotEngine in the reference's serving_0p5b configuration
               (hsd, gamma 5, K 1, temperature 1.0, 48 new tokens at most; 8
               slots, bucket 64, 4 pool blocks between admissions, 8
               admissions a step) on phase 5's int8 0.5B draft and the
               pair's bf16 0.5B trunk, 16 of the reference's 32 requests
               (cut for time), after one warm request, with the launch
               counters zeroed before and read after (K4 must launch; K1,
               K2, K3 and K8 must not); every request's tokens in range and
               within its budget, its accepts within [0, gamma] a block; BE
               and tok/s printed; the run again with the same seed gives
               identical streams; every served request must equal
               make_generate on its own generator in the 8-slot bf16
               engine whose target trunk runs one slot's rows a call
               (make_generate's row count), and two in a 1-slot engine and
               in the 8-slot engine on the pair's f32 image (f32
               activations, TF32 off); make_generate_batched on 4 prompts
               must equal per-request make_generate there; in bf16 with
               the trunk over all 8 slots' rows a call, which cuBLAS
               rounds differently, the agreement is printed. With --trace,
               also the run's parts
               timed apart (pool blocks, draft and target forwards, the
               verifier, noise, prefills) and one profiled pool block
               (device time by kernel, idle share)
  5h. uad      make_uad_generate on the 48-layer 14B int4 trunk with a
               char-level toy tokenizer pair and a context-repeat drafter,
               64 new tokens, with the launch counters zeroed before and read
               after (K1, K2 and K3 must launch, K8 must not)
  5i. eval     the evaluation layer on phase 5's pair: the target's and
               the draft's 2047- and 2046-row prefills of a GSM8K prompt
               (the 2048 bucket, route A), timed with their peak
               allocation; eval.gsm8k.run_eval (hsd, gamma 10, K 1,
               temperature 1.0, 128 new tokens) over the 5 rows of
               data/gsm8k/question.jsonl with the port's prompt_original
               and ByteTokenizer (each prompt ~3.3 kB: bucket 2048,
               truncated), with the launch counters zeroed before and read
               after (K1, K2, K3 and K4 must launch, K8 must not): the
               artifacts in the reference's shapes, summarize's BE the mean
               of accepts + 1 in the counts file, question 0's tokens those
               of make_generate called with the generator run_eval derives
               for it, bit for bit; then eval.benches.run_multibench (hsd,
               32 new tokens, warmup 1) over the first row of each of the
               8 data/*/question.jsonl files (both mt_bench turns), keyed
               100 x the bench's index + its id and fed in descending
               order: evaluate_info_file reads 8 rows and
               reorg_answer_file puts the 8 answers in question-id order
  6. greedy    temperature 0 on a 2-layer float32 pair built through the same
               kernels: the speculative stream must equal the AR stream, and
               so must every SlotEngine request and every make_generate_
               batched row, at K 1 and at K 2 striped, and UAD's stream; at
               full width only the common prefix length is printed
  7. eagle weights  the 14B pair is freed; the EAGLE serving pair is built on
               the card: a 32-layer Llama-3.1-8B-geometry symmetric-int8
               target (int8 embedding and head) coupled to the bigram oracle
               of a bf16 EAGLE-1 head (draft vocab 32000, top_k 10, depth 6,
               59 nodes; scale 6.0, lam 1.312), gptq_mxu_bf16 on
  8. eagle kernels  K5 (int8, fused RMSNorm) at 1 and 60 rows, K7 (bf16
               tensor-core operands) at 129 and 480 rows, each K7 case with
               its TFLOP/s and its share of the bound, and K4 (symmetric
               int8) at the prefill's shapes (wo, wdown at 64 rows, the head
               at 1 row and at 64) against their plain versions, timed as in
               phase 4; K7's pre-pass (the inverse RMS and the normed bf16
               rows) against its plain version at 129, 480 and 1024 rows; a
               row's bits at 1, 17 and 64 vs 128 rows (K5 wqkv, K4 wdown;
               bf16 and f32 activations) and 129 and 480 vs 1024 rows (K7)
  9. eagle serving  one 64-token prefill with the head on the last position
               against one with every position's logits: the last row must
               agree, both timed; then EagleSlotEngine (8 slots, bucket 64, 4
               pool blocks between admissions) on 16 requests of 32-64 prompt
               ids and 64 new tokens, in hsd_ref and hsd, after one warm
               request, with the launch counters zeroed before and read after
               (K4, K5 and K7 must each launch); hsd_ref again, whose token
               streams must be identical. With --trace, also a profiled pool
               step (device time by kernel, idle share)
 9f. eagle single request  make_eagle_generate (hsd_ref) on the 8B pair,
               one 64-token prompt and 64 new tokens, FLASH_DECODE =
               "always": the tree forward runs K8 with its bias
 10. eagle greedy  temperature 0 on a 2-layer float32 Llama-shaped pair with a
               symmetric-int8 target: make_eagle_generate and every server
               request must equal the AR stream, through K5
 10g. greedy K8  on 2-layer float32 pairs with head_dim 64 and caches of at
               least 128 slots, under each K8 mode: speculative, stepwise,
               recursive and prompt-lookup streams, and EAGLE's, must equal
               AR; K8 counted around each engine and its AR baseline apart
               must launch in both, but EAGLE's tree (it carries a bias)
               stays on the einsum route under FUSED_ATTN and launches none
 11. int4 eagle kernels  the int8 pair is freed; the same EAGLE pair with a
               packed-int4 trunk and head (big_bits 4) is built; K7i4 (bf16
               tensor-core operands on packed int4) at 129 and 480 rows on
               wqkv and wgu with the norm, wo, wdown and the head, each with
               its TFLOP/s and its share of the bound, and K1/K3 at the
               prefill's 64 rows and the head at 1 row, against their plain
               versions, timed as in phase 4; K7i4's pre-pass (the inverse
               RMS, the normed bf16 rows and the group sums of the unrounded
               ones) against its plain version at 129 and 480 rows; a row's
               bits at 129 vs 480 rows; an asymmetric int4 and int8 weight through the
               bf16 route (apply_linear) vs plain; K7 (int8) launches only
               for the int8 weight, K7i4 never at 128 rows; at 129 rows
               without mxu_bf16, route A on wqkv and wgu with the norm and
               the head: no kernel launches
 12. int4 eagle serving  phase 9's serving run on the int4 pair (hsd_ref,
               hsd, hsd_ref again with identical streams): K7i4, K1 and K3
               must launch, K4, K5, K7 and K8 must not; the int8 run's BE
               beside it
 13. eagle-3 head  the EAGLE3-LLaMA3.1-8B config written to a file and read
               by EagleConfig.from_json, a random v3 head int8-quantized by
               quantize_eagle_params, served (hsd, 8 requests) over the int4
               trunk as a plain target with its three feature taps (the head
               is random: BE near 1 is expected); K4 (the head) and K7i4 must
               launch; one make_eagle_generate with the static tree
               mc_sim_7b_63; autotune_total_tokens over (23, 47, 59)
 14. greedy v3  on 2-layer float32 pairs with a packed-int4 trunk: greedy
               v3 EAGLE, static-tree EAGLE and every EagleSlotEngine v3
               request must equal AR
 15. mixtral   the EAGLE pairs are freed; phase 5's coupled pair with
               Mixtral-8x7B's full geometry (32 layers, 8 experts, top-2,
               D 4096, F 14336, vocab 32000) as the packed-int4 trunk and
               the 0.5B draft at vocab 32000: its GiB; K3 at the expert
               shapes (11 rows) vs plain, timed as in phase 4; hsd and
               tokenwise (gamma 10, K 1) on phase 5's three prompts x 64
               new tokens and AR over 32, printing BE and tok/s (no bar: lam
               0, the BE comes from the 0.5B trunk), K1, K3, K4 launched
               and K2, K6, K7, K7i4, K8 not (with --trace, a profiled
               64-token hsd window); one 11-row target verify
               launching K1 exactly 32 and K3 exactly 32 * (1 + 24) + 1 =
               801 times, its wall ms and, under the profiler, its device ms
               by kernel and idle share; layer 0's router logits, top-k and
               _moe_ffn output bitwise equal at 1, 11 and 64 rows; greedy
               spec vs AR over 64 tokens on the target alone (gamma 4; the
               common prefix, printed)
 15g. greedy moe  2-layer float32 MoE targets (4 experts, top-2, D 256,
               F 512) with packed-int4 symmetric weights, int8 asymmetric
               experts and packed-int4 asymmetric experts with desc_act
               perms: one target forward launches exactly K1 2 / K3 27, K4
               24 and K3 24 respectively; greedy hsd, tokenwise and EAGLE-3
               over each must equal AR
 16. loader    a 1-layer Mixtral GPTQ checkpoint at full width (auto-gptq
               v1: int32-packed 4-bit codes and zero points, f16 scales,
               group 128, g_idx permuted on expert 5's w2; f16 embedding and
               lm_head; ~1.3 GB) written with this script's own safetensors
               writer from a seeded numpy generator, with a random f16
               EAGLE-3 head beside it; load_hf onto the card; on 64 and
               11 rows of the normed embedding, every layer-0 expert
               product against its plain version (dequantize, then an f32
               matmul), each one K3 launch (zero points; the perm's
               gather), and the MoE block against its plain version, 24 K3
               launches; then the phase's counted run: a 64-token prefill
               and an 11-row decode step, Eagle.from_pretrained, generate
               32 tokens in hsd mode (tokens in range, accepts within the
               trie's depth) and naive_generate 32; the directory deleted
 17. oracle    the realistic row's pair (eval/oracle.py) on the card, cut
               from 1800 to 200 steps each: the reference's language
               (make_language from its seed), a 4L/256H target trained by
               next-token CE and a 2L/128H draft distilled against it
               (vocab 2048, f32, AdamW under the warmup-cosine schedule);
               each final loss must lie below its step-0 loss; ratio_stats,
               then one 256-token tokenwise and one hsd generate (gamma 10)
               through the trained pair: tokens in range, accepts in [0,
               gamma]; no kernel launches (dense f32 models)
 18. train     EAGLE head training over phase 9's frozen int8 8B trunk
               (run right after 9f): byte-tokenized conversations from a
               seed through train.data (llama3 template, bucket 512), the
               draft vocabulary (count_tokens + build_draft_vocab, 32000 of
               128256), an EAGLE-3 head at the published EAGLE3-LLaMA3.1-8B
               width in dense bf16; 10 train.eagle3 steps (7 chained steps,
               lr 1e-3, warmup 2, total 100) on one repeated 2 x 512 batch:
               every loss finite, step 0 (lr 0) leaves the weights, the last
               loss below step 1's, embed / d2t / t2d bit-equal; launches: K7
               and no other kernel (wdown declines the bf16 route); the
               step's peak GiB and tokens/s, then one more step with each
               part timed alone (target forward, head forward, backward,
               clip, AdamW); one 1 x 2048 step (every product on route A: no
               launch), its time and peak GiB; dump_features of the batch
               (its f16 shard's non-finite share: the trunk's layer inputs
               reach ~1e6), then on the same codes with each layer's scales
               over sqrt(in) and a head over the full vocabulary: 3 online
               and 3 offline steps from one head, their losses within 1e-2
               (f16 shards; the target argmaxes that f16 moves printed), the
               offline step-0 loss within 1e-4 of the online loss on the
               f16-rounded inputs; 3
               train.eagle1 steps with phase 9's v1 head geometry (finite,
               K7 alone); make_kacc_probe on the batch (5 values in [0, 1]);
               a checkpoint round trip at full width (params and Adam
               moments bit-equal; seconds and bytes; the directory deleted)
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.
"""
import argparse
import contextlib
import dataclasses
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    sys.exit(1)

from hsd_tpu_torch.config import EngineConfig, ModelConfig, VerifierConfig
from hsd_tpu_torch.engine import (make_autoregressive, make_generate,
                                  make_prompt_lookup_generate,
                                  make_recursive_generate,
                                  make_stepwise_generate, make_stream_generate)
from hsd_tpu_torch.engine.eagle_engine import (autotune_total_tokens,
                                               make_eagle_generate)
from hsd_tpu_torch.engine.eagle_server import EagleSlotEngine
from hsd_tpu_torch.engine.server import SlotEngine
from hsd_tpu_torch.engine.speculative import make_generate_batched
from hsd_tpu_torch.engine.uad import UadDrafter, make_uad_generate
from hsd_tpu_torch.eval.synthetic import (build_coupled_eagle_pair,
                                          build_coupled_pair, group_size,
                                          init_quantized_params,
                                          make_coupled_eagle_target,
                                          make_coupled_target, quantize_draft)
from hsd_tpu_torch.models.choices import (build_tree_buffers,
                                          eagle_config_for_tree, mc_sim_7b_63)
from hsd_tpu_torch.models.eagle import (EagleConfig, init_eagle_params,
                                        quantize_eagle_params)
from hsd_tpu_torch.engine.kvcache import init_cache, select_draft_row
from hsd_tpu_torch.modeling_eagle import Eagle
from hsd_tpu_torch.models.loader import load_hf
from hsd_tpu_torch.engine.speculative import draft_rows
from hsd_tpu_torch.ops.sampling import processor
from hsd_tpu_torch.models import transformer
from hsd_tpu_torch.models.transformer import (fuse_params, init_params,
                                              rope_tables)
from hsd_tpu_torch.ops import _build, launch_counts, reset_launches
from hsd_tpu_torch.ops import flash_decode as FD
from hsd_tpu_torch.ops import gptq_cuda as G
from hsd_tpu_torch.ops.linear import (QuantizedLinear, apply_linear,
                                      apply_mlp, dequantize, quantize,
                                      rms_norm)
from hsd_tpu_torch.tools import bench_main as BM

DEV = torch.device("cuda")
HBM_BYTES_S = 3.35e12       # H100 SXM device memory rate
# H100 SXM dense bf16 tensor-core rate: the operands are bf16 activations
# and int4/int8 codes, which the tensor cores take at this rate
BF16_FLOP_S = 989e12
TOL = 2.0 ** -7             # kernel vs plain, relative to the output's max
GAMMA, MAX_NEW, N_PROMPTS, BUCKET, AR_NEW = 10, 128, 3, 64, 32
LOGIT_SCALE = 1.467
SPIN_CYCLES = 2_000_000      # ~1 ms of device spin before a timed call
# EAGLE serving, cut from bench.py's row: 24 -> 16 requests, 96 -> 64 new
EAGLE_SLOTS, EAGLE_BUCKET, EAGLE_REQS, EAGLE_NEW, EAGLE_MACRO = 8, 64, 16, 64, 4
SPEC_KERNELS = ("K1", "K2", "K3", "K4")    # phase 5's path
# the speculative path's cache: bucket + new tokens + gamma + 2 slots
SPEC_S = BUCKET + MAX_NEW + GAMMA + 2
EAGLE_S = 64 + 64 + 59 + 2                 # one EAGLE request (phase 9f)
ENGINE_NEW, ENGINE_GAMMA = 64, 4           # phase 5d
STRIPED_K, STRIPED_NEW = 2, 64             # phase 5f: R = 1 + 10 * (2 - 1)
SERVING_REQS = 16                          # phase 5g: cut from the row's 32
UAD_NEW, UAD_GAMMA = 64, 4                 # phase 5h
EVAL_NEW, EVAL_BENCH_NEW = 128, 32         # phase 5i: GSM8K, multi-bench
EVAL_BENCHES = ("mt_bench", "alpaca", "qa", "sum", "humaneval", "gsm8k",
                "flores200", "cnndailymail")
ORACLE_STEPS, ORACLE_NEW = 200, 256        # phase 17: cut from 1800 steps
REPO = os.path.dirname(os.path.abspath(__file__))
LONG_LENS, LONG_ITERS = (1056, 2080, 4128), 10
MIXTRAL_VERIFY = 11                        # phase 15: gamma + 1 rows
MIXTRAL_NEW = 64                           # phase 15: cut from phase 5's 128
MIXTRAL_ROWS = (1, 11, 64)                 # phase 15's row-bit check
MIXTRAL_GREEDY_NEW, MIXTRAL_GREEDY_GAMMA = 64, 4
LOADER_SEED, LOADER_PERM = 16, 5           # phase 16: w2 of expert 5 permuted
TRAIN_B, TRAIN_T, TRAIN_STEPS = 2, 512, 10  # phase 18: one repeated batch
TRAIN_LONG = 2048                          # phase 18: the reference's max_len
TRAIN_TC = dict(steps=7, lr=1e-3, warmup_steps=2, total_steps=100)
OFFLINE_RTOL = 1e-2      # offline vs online losses: the shards are f16
EXACT_RTOL = 1e-4        # offline step 0 vs online on the f16 image
T0 = time.time()


def log(msg):
    print(f"[{time.time() - T0:6.1f}s] {msg}", flush=True)


_FLUSH = None


def timed(fn, n_sets, repeats=12):
    """Median device milliseconds of one call fn(l), l cycling over n_sets
    distinct weight sets, with the 50 MB L2 flushed before each call so the
    weights stream from device memory as they do on the main path."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(96 * 2**20, dtype=torch.uint8, device=DEV)
    fn(0)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    out = []
    for r in range(repeats):
        _FLUSH.zero_()
        # keep the device busy while the host enqueues the call, so the
        # window holds device time only, not the wrapper's host overhead
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn(r % n_sets)
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return statistics.median(out)


def bound(bytes_moved, flops):
    t_b, t_f = bytes_moved / HBM_BYTES_S, flops / BF16_FLOP_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def qbytes(w: QuantizedLinear):
    return sum(t.numel() * t.element_size()
               for t in (w.qweight, w.scales, w.zeros) if t is not None)


def deq_bf16(w: QuantizedLinear):
    if w.packed_int4:
        return G.dequantize_int4(w.qweight, w.scales, w.zeros).to(torch.bfloat16)
    return G.dequantize_int8(w.qweight, w.scales, w.zeros).to(torch.bfloat16)


KERNEL_ROWS = []      # one dict per (kernel, shape)


def check_kernel(name, label, n, run, plain, library, n_sets, nbytes, flops):
    """run(l) / plain(l) compute layer l's call; library(l) is the one-call
    PyTorch yardstick (or None)."""
    got, want = run(0), plain(0)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = math.isfinite(err) and err <= TOL * scale
    ms = timed(run, n_sets)
    plain_ms = timed(plain, 1, repeats=3)
    lib_ms = timed(library, 1) if library is not None else None
    b_ms, b_by = bound(nbytes, flops)
    row = dict(name=name, label=label, n=n, max_abs_err=err,
               rel_err=err / scale if scale else err, ms=ms, flops=flops,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by)
    KERNEL_ROWS.append(row)
    lib_s = f"{lib_ms:.4f}" if lib_ms is not None else "n/a"
    log(f"{name} {label:<28} n={n:<3} err={err:.3e} "
        f"(rel {row['rel_err']:.2e}, tol {TOL:.2e}) kernel={ms:.4f}ms "
        f"plain={plain_ms:.4f}ms library={lib_s}ms "
        f"bound={b_ms:.4f}ms ({b_by})")
    if not ok:
        raise AssertionError(f"{name} {label} n={n}: error {err} > "
                             f"{TOL} x {scale}")


def _bf16_plain(int8, x, w, ln, eps):
    """K7 / K7i4's plain version: the norm-fused form with ln."""
    if ln is not None:
        fn = G.int8_ln_matmul_plain if int8 else G.int4_ln_matmul_plain
        return fn(x, w.qweight, w.scales, ln, eps, bf16_operands=True)
    fn = G.int8_matmul_plain if int8 else G.int4_matmul_plain
    return fn(x, w.qweight, w.scales, w.zeros, bf16_operands=True)


# kernel name -> (wrapper, plain version), each of (x, w, ln or None, eps)
QUANT_CALLS = {
    "K1": (lambda x, w, ln, eps: G.int4_ln_matmul(x, w.qweight, w.scales,
                                                  ln, eps),
           lambda x, w, ln, eps: G.int4_ln_matmul_plain(x, w.qweight,
                                                        w.scales, ln, eps)),
    "K3": (lambda x, w, ln, eps: G.int4_matmul(x, w.qweight, w.scales,
                                               w.zeros),
           lambda x, w, ln, eps: G.int4_matmul_plain(x, w.qweight, w.scales,
                                                     w.zeros)),
    "K4": (lambda x, w, ln, eps: G.int8_matmul(x, w.qweight, w.scales,
                                               w.zeros),
           lambda x, w, ln, eps: G.int8_matmul_plain(x, w.qweight, w.scales,
                                                     w.zeros)),
    "K5": (lambda x, w, ln, eps: G.int8_ln_matmul(x, w.qweight, w.scales,
                                                  ln, eps),
           lambda x, w, ln, eps: G.int8_ln_matmul_plain(x, w.qweight,
                                                        w.scales, ln, eps)),
    "K7": (lambda x, w, ln, eps: G.int8_matmul_bf16(x, w.qweight, w.scales,
                                                    w.zeros, ln, eps),
           lambda x, w, ln, eps: _bf16_plain(True, x, w, ln, eps)),
    "K7i4": (lambda x, w, ln, eps: G.int4_matmul_bf16(x, w.qweight,
                                                      w.scales, w.zeros, ln,
                                                      eps),
             lambda x, w, ln, eps: _bf16_plain(False, x, w, ln, eps)),
}


def quant_case(name, label, w: QuantizedLinear, n, act, ln, eps):
    """One quantized product against its plain version (check_kernel) on
    up to four layers of a stacked weight; ln: [layers, din] norm weights,
    or None. The library call is a bf16 torch.matmul against the
    pre-dequantized weight."""
    stacked = w.qweight.dim() == 3
    n_sets = min(4, w.qweight.shape[0]) if stacked else 1
    ws = [w.layer(l) if stacked else w for l in range(n_sets)]
    x = act(n, w.din)
    dout = w.qweight.shape[-1]
    kern, plain = QUANT_CALLS[name]
    lnl = (lambda l: None) if ln is None else (lambda l: ln[l])
    w_bf16 = deq_bf16(ws[0])
    check_kernel(name, label, n, lambda l: kern(x, ws[l], lnl(l), eps),
                 lambda l: plain(x, ws[l], lnl(l), eps),
                 lambda l: torch.matmul(x, w_bf16), n_sets,
                 qbytes(ws[0]) + x.numel() * 2 + n * dout * 2
                 + (w.din * 4 if ln is not None else 0),
                 2 * n * w.din * dout)
    del w_bf16


ROUTE_A_ROWS = []     # one dict per (shape, rows) of the dequantize route


def route_a_case(label, w: QuantizedLinear, rows, act, ln, eps,
                 mxu_bf16=False):
    """apply_linear on up to four layers of a stacked weight at each row
    count of `rows`, all above 128 and outside the bf16 route: the
    reference's dequantize-then-dot route, which must launch no kernel and
    agree with the f32 plain version within TOL (the route rounds the
    normed x and the weight to bf16). Timed as check_kernel times a
    kernel, with the device memory it allocates beyond its output."""
    stacked = w.qweight.dim() == 3
    n_sets = min(4, w.qweight.shape[0]) if stacked else 1
    ws = [w.layer(l) if stacked else w for l in range(n_sets)]
    for n in rows:
        x = act(n, w.din)
        norm = (lambda l: None) if ln is None else (lambda l: (ln[l], eps))
        run = lambda l: apply_linear(ws[l], x, norm=norm(l),
                                     mxu_bf16=mxu_bf16)
        before = launch_counts()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = run(0)
        torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated() - base
                 - got.numel() * got.element_size())
        used = {k: v - before[k] for k, v in launch_counts().items()
                if v != before[k]}
        if used:
            raise AssertionError(f"route A {label} n={n} launched {used}")
        xs = G._rms_f32(x, ln[0], eps) if ln is not None else x
        plain = (G.int4_matmul_plain if w.packed_int4
                 else G.int8_matmul_plain)
        want = plain(xs, ws[0].qweight, ws[0].scales, ws[0].zeros)
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        ms = timed(run, n_sets)
        ROUTE_A_ROWS.append(dict(label=label, n=n, ms=ms, alloc_gib=extra
                                 / 2**30, max_abs_err=err))
        log(f"route A {label:<28} n={n:<3} no kernel launches, err={err:.3e}"
            f" (rel {err / scale:.2e}, tol {TOL:.2e}) {ms:.4f}ms, "
            f"{extra / 2**30:.3f} GiB allocated beside the output")
        if not (math.isfinite(err) and err <= TOL * scale):
            raise AssertionError(f"route A {label} n={n}: error {err}")


def kernel_phase(draft, target, cfg_b):
    g = torch.Generator(device=DEV).manual_seed(123)
    big = target.big.layers
    D = cfg_b.hidden_size
    eps = cfg_b.rms_norm_eps
    # norm weights away from 1 so the fused norm's weight is exercised
    ln = torch.rand((4, D), generator=g, device=DEV) + 0.5

    def act(n, d):
        return torch.randn((n, d), generator=g, device=DEV).to(torch.bfloat16)

    def linear_case(name, label, w: QuantizedLinear, n):
        quant_case(name, label, w, n, act, ln if name == "K1" else None, eps)

    # a row's bits do not depend on how many rows share its launch
    x = act(128, D)
    w, wd = big["wqkv"].layer(0), big["wdown"].layer(0)
    dw = draft.layers["wgu"].layer(0)
    xd, xf = act(62, dw.din), act(128, wd.din)
    k1 = lambda x: G.int4_ln_matmul(x, w.qweight, w.scales, ln[0], eps)
    k3 = lambda x: G.int4_matmul(x, wd.qweight, wd.scales)
    k4 = lambda x: G.int8_matmul(x, dw.qweight, dw.scales, dw.zeros)
    full1, full3, full4 = k1(x), k3(xf), k4(xd)
    for n in (1, 11, 63, 121):
        if not (torch.equal(k1(x[:n]), full1[:n])
                and torch.equal(k3(xf[:n]), full3[:n])):
            raise AssertionError(f"K1/K3 rows differ between {n} and 128 "
                                 "rows")
    for n in (1, 2, 11):
        if not torch.equal(k4(xd[:n]), full4[:n]):
            raise AssertionError(f"K4 rows differ between {n} and 62 rows")
    log("kernels: K1 (wqkv) and K3 (wdown) give the same bits for a row at "
        "1, 11, 63, 121 and 128 rows; K4 at 1, 2, 11 and 62")

    log("kernels: K1 (int4, fused RMSNorm)")
    for n in (1, 11, 63, 121, 128, 7):
        linear_case("K1", "target wqkv 5120x7168", big["wqkv"], n)
    linear_case("K1", "target wgu 5120x27648", big["wgu"], 63)

    log("kernels: K3 (int4)")
    for n in (1, 11):
        linear_case("K3", "target lm_head 5120x151936", target.big.lm_head, n)
    linear_case("K3", "target wo 5120x5120", big["wo"], 63)
    for n in (63, 121, 128):
        linear_case("K3", "target wdown 13824x5120", big["wdown"], n)
    ragged = QuantizedLinear(big["wo"].qweight[0, :, :1000].contiguous(),
                             big["wo"].scales[0, :, :1000].contiguous(), None)
    linear_case("K3", "ragged 5120x1000", ragged, 7)
    route_a_case("target wqkv 5120x7168 +norm", big["wqkv"], (200, 693),
                 act, ln, eps)
    route_a_case("target wdown 13824x5120", big["wdown"], (200, 693), act,
                 None, eps)

    log("kernels: K4 (int8, zero points)")
    for nm in ("wqkv", "wo", "wgu", "wdown"):
        w = draft.layers[nm]
        for n in (1, 2, 62, 64):
            linear_case("K4", f"draft {nm} {w.din}x{w.qweight.shape[-1]}",
                        w, n)

    log("kernels: K2 (fused int4 layer tail)")
    wo, wgu, wdown, ln2 = big["wo"], big["wgu"], big["wdown"], ln
    tail_bytes = sum(qbytes(w.layer(0)) for w in (wo, wgu, wdown))
    F2 = wgu.qweight.shape[-1]
    # yardstick, not one call: the tail's three products as bf16 matmuls
    # against pre-dequantized weights, with the SwiGLU and both residuals
    # but no norm (JSON library_ms stays null for K2)
    w3 = [deq_bf16(w.layer(0)) for w in (wo, wgu, wdown)]

    def three_matmuls(att, res):
        xp = res + torch.matmul(att, w3[0])
        gu = torch.matmul(xp, w3[1])
        ff = torch.nn.functional.silu(gu[:, :F2 // 2]) * gu[:, F2 // 2:]
        return xp + torch.matmul(ff, w3[2])

    def tail(att, res, l=0):
        return G.attn_mlp_int4(att, res, wo.qweight[l], wo.scales[l],
                               wgu.qweight[l], wgu.scales[l],
                               wdown.qweight[l], wdown.scales[l], ln2[l], eps)

    att, res = act(32, D), act(32, D)
    full = tail(att, res)
    for n in (1, 7, 11):
        if not torch.equal(tail(att[:n], res[:n]), full[:n]):
            raise AssertionError(f"K2 rows differ between {n} and 32 rows")
    log("kernels: K2 (the 14B tail) gives the same bits for a row at 1, 7, "
        "11 and 32 rows")
    for n in (1, 11, 7, 32):
        att, res = act(n, D), act(n, D)

        def run(l):
            return tail(att, res, l)

        def plain(l):
            return G.attn_mlp_int4_plain(att, res, wo.qweight[l],
                                         wo.scales[l], wgu.qweight[l],
                                         wgu.scales[l], wdown.qweight[l],
                                         wdown.scales[l], ln2[l], eps)
        check_kernel("K2", "target tail 5120/27648/13824", n, run, plain,
                     lambda l: three_matmuls(att, res), 4,
                     tail_bytes + 3 * n * D * 2,
                     2 * n * (D * D + D * F2 + F2 // 2 * D))


@contextlib.contextmanager
def opted_in(attr):
    """One of the JAX package's K8 opt-ins (FD.FUSED_ATTN or
    FD.FLASH_DECODE) set to "always" inside the block."""
    setattr(FD, attr, "always")
    try:
        yield
    finally:
        setattr(FD, attr, "auto")


# (label, H, Hkv, d, T, S, kv_length, start, bias) of K8 on the paths below
ATTN_SHAPES = [
    ("0.5B draft", 14, 2, 64, 1, SPEC_S, SPEC_S - 40, 3, None),
    ("0.5B draft", 14, 2, 64, 2, SPEC_S, SPEC_S - 40, 3, None),
    ("14B verify", 40, 8, 128, 11, SPEC_S, SPEC_S - 40, 3, None),
    ("8B EAGLE tree", 32, 8, 128, 60, EAGLE_S, 100, 0, "tree"),
    ("8B EAGLE prefill", 32, 8, 128, 64, EAGLE_S, 0, 0, "zero"),
] + [("14B long context", 40, 8, 128, T, L + 64, L, 0, None)
     for L in LONG_LENS for T in (1, 11)]
K8_REP = ("0.5B draft 14/2/64 S=204 +rope", 1)   # the path's most frequent


def attention_case(H, Hkv, d, T, S, kv_len, start, bias, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = (torch.randn((T, H, d), generator=g, device=DEV) * 2).to(torch.bfloat16)
    k = torch.randn((S, Hkv, d), generator=g, device=DEV).to(torch.bfloat16)
    v = torch.randn((S, Hkv, d), generator=g, device=DEV).to(torch.bfloat16)
    qi = kv_len + torch.arange(T, device=DEV)
    st = torch.tensor([start], device=DEV)
    ab = None
    if bias == "tree":          # node i attends to its ancestor chain
        anc = torch.rand((T, T), generator=g, device=DEV) < 0.6
        anc = torch.tril(anc) | torch.eye(T, dtype=torch.bool, device=DEV)
        ab = torch.where(anc, 0.0, -1e30)
    elif bias == "zero":        # the JAX EAGLE prefill's [P, P] zero bias
        ab = torch.zeros((T, T), device=DEV)
    cos2, sin2 = rope_tables((qi - start)[None], d, 1e6)
    return q, k, v, qi, st, ab, (cos2[0, :, 0], sin2[0, :, 0])


def attention_phase():
    """K8 against its plain version at every path shape, in both forms."""
    for i, (label, H, Hkv, d, T, S, kv_len, start, bias) in enumerate(
            ATTN_SHAPES):
        q, k, v, qi, st, ab, rope = attention_case(H, Hkv, d, T, S, kv_len,
                                                   start, bias, i)
        rep = H // Hkv
        # the library call: SDPA on the repeated K/V with the same mask
        kp = torch.arange(S, device=DEV)
        valid = (kp[None] <= qi[:, None]) & (kp[None] >= start)
        bias_all = torch.zeros((T, S), device=DEV)
        if ab is not None:
            bias_all[:, kv_len:kv_len + T] = ab
        fmask = torch.where(valid, bias_all, float("-inf")).to(torch.bfloat16)
        kr = k.permute(1, 0, 2).repeat_interleave(rep, 0)[None]
        vr = v.permute(1, 0, 2).repeat_interleave(rep, 0)[None]
        for fused in (False, True):
            rp = rope if fused else None
            qr = (FD.rope_rotate(q.float(), rope).to(torch.bfloat16)
                  if fused else q).permute(1, 0, 2)[None]

            def run(l, rp=rp):
                return FD.flash_decode(q, k, v, qi, st, kv_len, ab, rp)

            def plain(l, rp=rp):
                return FD.flash_core_plain(q, k, v, qi, st, kv_len, ab,
                                           rp).to(torch.bfloat16)

            def library(l, qr=qr):
                return torch.nn.functional.scaled_dot_product_attention(
                    qr, kr, vr, attn_mask=fmask)

            name = (f"{label} {H}/{Hkv}/{d} S={S}" + (" +rope" if fused
                                                       else ""))
            check_kernel("K8", name, T, run, plain, library, 1,
                         2 * S * Hkv * d * 2, 4 * T * H * S * d)
    # a query row's bits do not depend on how many rows share its launch
    q, k, v, qi, st, _, rope = attention_case(40, 8, 128, 11, SPEC_S,
                                              SPEC_S - 40, 3, None, 99)
    for rp in (None, rope):
        full = FD.flash_decode(q, k, v, qi, st, SPEC_S - 40, None, rp)
        for t in range(11):
            one = FD.flash_decode(
                q[t:t + 1], k, v, qi[t:t + 1], st, SPEC_S - 40 + t, None,
                None if rp is None else (rp[0][t:t + 1], rp[1][t:t + 1]))
            if not torch.equal(one, full[t:t + 1]):
                raise AssertionError(f"K8 row {t} differs between T = 1 "
                                     "and T = 11")
    log("attention: K8 gives the same bits for a query row at T = 1 and "
        "T = 11, in both forms")


def mlp_phase(target, cfg_b):
    """K6 through its route, `apply_mlp` on the 14B target's layer-stacked
    MLP weights with a layer index: every layer at 1 and 11 rows, with the
    launch counters zeroed before and read after (K6 must launch once a
    call, and nothing else), each call against its plain version; then
    timed through the same route. Returns the route's launch counts."""
    g = torch.Generator(device=DEV).manual_seed(456)
    big = target.big.layers
    D, eps = cfg_b.hidden_size, cfg_b.rms_norm_eps
    wgu, wdown = big["wgu"], big["wdown"]
    L, F2 = wgu.qweight.shape[0], wgu.qweight.shape[-1]
    ln = torch.rand((L, D), generator=g, device=DEV) + 0.5
    xs = {n: torch.randn((n, D), generator=g, device=DEV).to(torch.bfloat16)
          for n in (1, 11)}

    def plain(x, l):
        return G.mlp_int4_plain(x, wgu.qweight[l], wgu.scales[l],
                                wdown.qweight[l], wdown.scales[l], ln[l], eps)

    torch.cuda.synchronize()
    reset_launches()
    outs = {(n, l): apply_mlp(wgu, wdown, x, ln[l], eps, layer=l)
            for n, x in xs.items() for l in range(L)}
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts["K6"] != len(outs) or sum(counts.values()) != len(outs):
        raise AssertionError(f"apply_mlp: launches {counts}, expected "
                             f"{len(outs)} of K6 alone")
    worst = 0.0
    for (n, l), got in outs.items():
        want = plain(xs[n], l).float()
        err = (got.float() - want).abs().max().item()
        if not err <= TOL * want.abs().max().item():
            raise AssertionError(f"apply_mlp layer {l}, {n} rows: error {err}")
        worst = max(worst, err)
    log(f"mlp: apply_mlp routed {len(outs)} calls ({L} layers x 1 and 11 "
        f"rows) to K6, max error {worst:.3e}; launches {counts}")
    x32 = torch.randn((32, D), generator=g, device=DEV).to(torch.bfloat16)

    def k6(x):
        return G.mlp_int4(x, wgu.qweight[0], wgu.scales[0], wdown.qweight[0],
                          wdown.scales[0], ln[0], eps)
    full = k6(x32)
    for n in (1, 7, 11, 32):
        got = full if n == 32 else k6(x32[:n])
        if n < 32 and not torch.equal(got, full[:n]):
            raise AssertionError(f"K6 rows differ between {n} and 32 rows")
        want = plain(x32[:n], 0).float()
        err = (got.float() - want).abs().max().item()
        if not err <= TOL * want.abs().max().item():
            raise AssertionError(f"K6 {n} rows: error {err}")
    log("mlp: K6 within tolerance at 1, 7, 11 and 32 rows and gives the "
        "same bits for a row at each")
    # yardstick, not one call: the MLP as two bf16 matmuls against
    # pre-dequantized weights and the SwiGLU, no norm (JSON library_ms
    # stays null for K6)
    w2 = [deq_bf16(w.layer(0)) for w in (wgu, wdown)]

    def two_matmuls(x):
        gu = torch.matmul(x, w2[0])
        return torch.matmul(torch.nn.functional.silu(gu[:, :F2 // 2])
                            * gu[:, F2 // 2:], w2[1])

    for n, x in xs.items():
        check_kernel("K6", "target mlp 5120/27648/13824", n,
                     lambda l, x=x: apply_mlp(wgu, wdown, x, ln[l], eps,
                                              layer=l),
                     lambda l, x=x: plain(x, l),
                     lambda l, x=x: two_matmuls(x), 4,
                     qbytes(wgu.layer(0)) + qbytes(wdown.layer(0))
                     + 2 * n * D * 2 + D * 4, 2 * n * (D * F2 + F2 // 2 * D))
    del w2
    return counts


def opted_in_main_path(draft, target, cfg_s, cfg_b, phase5):
    """Phase 5's hsd on its first prompt and seed with K8 off (phase 5's run
    again) and with each K8 route, in turns (off, FUSED_ATTN, FLASH_DECODE,
    then the reverse): the same seed gives each route the same stream both
    times, so ms per block compares the routes."""
    fwd, ops = make_coupled_target(cfg_s, cfg_b)
    prompt = (torch.arange(BUCKET, device=DEV) % 1000) + 10
    eng = EngineConfig(verifier=VerifierConfig(method="hsd", gamma=GAMMA,
                                               num_drafts=1),
                       max_new_tokens=MAX_NEW, temperature=1.0)
    gen = make_generate(cfg_s, cfg_b, eng, target_forward=fwd,
                        target_cache_ops=ops)
    routes = ("off", "FUSED_ATTN", "FLASH_DECODE")
    out = {}
    for attr in routes + routes[::-1]:
        with (opted_in(attr) if attr != "off" else contextlib.nullcontext()):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            res = gen(draft, target, prompt, BUCKET,
                      torch.Generator(device=DEV).manual_seed(0))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = launch_counts()
        be = float((res.accepts[:res.blocks].float() + 1).mean())
        ms = secs / res.blocks * 1e3
        if attr in out:
            if be != out[attr]["be"]:
                raise AssertionError(f"{attr}: the repeat run's BE differs")
            out[attr]["ms_per_block"].append(ms)
            out[attr]["tok_s"].append(res.ncommit / secs)
        else:
            out[attr] = dict(be=be, tok_s=[res.ncommit / secs],
                             counts=counts, ms_per_block=[ms])
        log(f"main path hsd, K8 {attr}: BE {be:.4f} (phase 5 on this "
            f"prompt and seed: {phase5['hsd']['per_prompt'][0]:.4f}) "
            f"{res.ncommit / secs:.2f} tok/s, {res.ncommit} tokens in "
            f"{res.blocks} blocks, {ms:.1f} ms per block; launches {counts}")
        if (counts["K8"] > 0) != (attr != "off"):
            raise AssertionError(f"{attr}: K8 launches {counts['K8']}")
    base = statistics.mean(out["off"]["ms_per_block"])
    log("main path hsd, mean ms per block: " + ", ".join(
        f"{a} {statistics.mean(out[a]['ms_per_block']):.1f} "
        f"({statistics.mean(out[a]['ms_per_block']) / base - 1:+.1%})"
        for a in routes))
    return out


def engines_phase(draft, target, cfg_s, cfg_b):
    """The single-request engines at full width with FUSED_ATTN on."""
    big = target.big
    prompt = torch.tensor(([11, 97, 403, 52, 7, 301, 88, 64, 930] * 8)
                          [:BUCKET], device=DEV)
    eng = EngineConfig(verifier=VerifierConfig(method="hsd",
                                               gamma=ENGINE_GAMMA),
                       max_new_tokens=ENGINE_NEW, temperature=1.0)

    def gen(seed):
        return torch.Generator(device=DEV).manual_seed(seed)

    def check(name, toks):
        if not toks or not all(0 <= t < cfg_b.vocab_size for t in toks):
            raise AssertionError(f"{name}: bad stream")

    out = {}
    with opted_in("FUSED_ATTN"):
        torch.cuda.synchronize()
        reset_launches()
        for name, make in (("stepwise", make_stepwise_generate),
                           ("recursive", make_recursive_generate)):
            t0 = time.perf_counter()
            res = make(cfg_s, cfg_b, eng)(draft, big, prompt, BUCKET, gen(1))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            check(name, res.tokens[BUCKET:res.length].tolist())
            out[name] = dict(tokens=res.ncommit, blocks=res.blocks,
                             secs=secs)
            log(f"engines {name}: {res.ncommit} tokens in {res.blocks} "
                f"blocks ({secs:.2f}s), accepted per block "
                f"{res.accepts[:res.blocks].tolist()[:12]}..., rounds "
                f"{res.rounds[:res.blocks].tolist()[:12]}...")
        t0 = time.perf_counter()
        chunks = list(make_stream_generate(cfg_s, cfg_b, eng)(
            draft, big, prompt, BUCKET, gen(3)))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        res = make_generate(cfg_s, cfg_b, eng)(draft, big, prompt, BUCKET,
                                               gen(3))
        stream = [t for c in chunks for t in c.tolist()]
        check("streaming", stream)
        if stream != res.tokens[BUCKET:res.length].tolist():
            raise AssertionError("streamed chunks != make_generate's stream")
        out["streaming"] = dict(tokens=len(stream), chunks=len(chunks),
                                secs=secs)
        log(f"engines streaming: {len(chunks)} chunks, {len(stream)} tokens "
            f"({secs:.2f}s), concatenated == make_generate's stream")
        t0 = time.perf_counter()
        toks, length, acc, blocks = make_prompt_lookup_generate(cfg_b, eng)(
            big, prompt, BUCKET, gen(4))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check("prompt lookup", toks[BUCKET:length].tolist())
        out["prompt_lookup"] = dict(tokens=length - BUCKET, blocks=blocks,
                                    secs=secs)
        log(f"engines prompt lookup: {length - BUCKET} tokens in {blocks} "
            f"blocks ({secs:.2f}s), accepted {acc[:blocks].tolist()[:12]}...")
        counts = launch_counts()
    log(f"engines: launches {counts}")
    if counts["K8"] <= 0:
        raise AssertionError("the engines did not launch K8")
    out["counts"] = counts
    return out


def striped_phase(draft, target, cfg_s, cfg_b):
    """Phase 5f: the striped multidraft layout at full width."""
    fwd, ops = make_coupled_target(cfg_s, cfg_b)
    prompt = (torch.arange(BUCKET, device=DEV) % 1000) + 10
    R = 1 + GAMMA * (STRIPED_K - 1)

    def gen_for(method):
        eng = EngineConfig(verifier=VerifierConfig(
            method=method, gamma=GAMMA, num_drafts=STRIPED_K,
            parallel=False), max_new_tokens=STRIPED_NEW, temperature=1.0)
        return make_generate(cfg_s, cfg_b, eng, target_forward=fwd,
                             target_cache_ops=ops)

    def seeded(seed):
        return torch.Generator(device=DEV).manual_seed(seed)

    # one striped draft block on the R-row draft cache: a row whose
    # activation step is j was fed row 0's tokens through draft position
    # j - 1, so its entries up to there must be row 0's bits (K4 on R rows
    # is row-position-free). The prefill (route A, cuBLAS, 682 rows) is
    # made row 0's first, as the engine's row select does after a block.
    cache = init_cache(cfg_s, R, SPEC_S, DEV)
    _, cache = transformer.forward(cfg_s, draft, prompt[None, :-2].expand(
        R, BUCKET - 2), cache, skip_head=True)
    same = all(torch.equal(c[:, r], c[:, 0]) for c in (cache.k, cache.v)
               for r in range(1, R))
    log(f"striped draft prefill ({R} x {BUCKET - 2} rows, route A): rows "
        f"bitwise equal: {same}")
    cache = select_draft_row(cache, 0)
    toks, _, cache = draft_rows(
        cfg_s, draft, cache, prompt[-2], prompt[-1], GAMMA, STRIPED_K, True,
        processor(1.0), seeded(40))
    act = [0] + [j for j in range(GAMMA) for _ in range(STRIPED_K - 1)]
    L = BUCKET - 2
    differ = [r for r in range(1, R) if not (
        torch.equal(cache.k[:, r, :L + 2 + act[r]],
                    cache.k[:, 0, :L + 2 + act[r]])
        and torch.equal(cache.v[:, r, :L + 2 + act[r]],
                        cache.v[:, 0, :L + 2 + act[r]])
        and torch.equal(toks[r, :act[r]], toks[0, :act[r]]))]
    log(f"striped draft block on {R} rows: every mirrored row's tokens and "
        f"cache entries before its activation step are row 0's bits: "
        f"{not differ}")
    if differ:
        raise AssertionError(f"striped rows {differ} differ from row 0")
    del cache
    torch.cuda.synchronize()
    reset_launches()
    out = {}
    for i, method in enumerate(("hsd", "tokenwise", "hsd_ref")):
        t0 = time.perf_counter()
        res = gen_for(method)(draft, target, prompt, BUCKET, seeded(50 + i))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        stream = res.tokens[BUCKET:res.length]
        acc = res.accepts[:res.blocks]
        if not (res.ncommit >= 1 and int(stream.min()) >= 0
                and int(stream.max()) < cfg_b.vocab_size):
            raise AssertionError(f"striped {method}: bad stream")
        if not (int(acc.min()) >= 0 and int(acc.max()) <= GAMMA):
            raise AssertionError(f"striped {method}: accepts {acc.tolist()}")
        be = float((acc.float() + 1).mean())
        out[method] = dict(be=be, tokens=res.ncommit, blocks=res.blocks,
                           secs=secs, stream=stream.tolist())
        log(f"striped {method} (K {STRIPED_K}, {R} rows): BE {be:.4f}, "
            f"{res.ncommit} tokens in {res.blocks} blocks ({secs:.2f}s, "
            f"{res.ncommit / secs:.2f} tok/s), accepted per block "
            f"{acc.tolist()}")
    counts = launch_counts()
    log(f"striped: launches {counts}")
    for k in ("K1", "K3", "K4"):
        if counts[k] <= 0:
            raise AssertionError(f"striped: {k} was not launched")
    if counts["K8"]:
        raise AssertionError("striped: K8 launched on the default path")
    res = gen_for("hsd_ref")(draft, target, prompt, BUCKET, seeded(52))
    again = res.tokens[BUCKET:res.length].tolist()
    digest = hashlib.sha256(str(again).encode()).hexdigest()[:16]
    log(f"striped hsd_ref repeat with one seed: identical streams: "
        f"{again == out['hsd_ref']['stream']} (sha256 {digest})")
    if again != out["hsd_ref"]["stream"]:
        raise AssertionError("striped hsd_ref: the repeat's stream differs")
    out["counts"] = counts
    return out


def serving_engine(draft, small, cfg_s, n_slots=BM.SRV_SLOTS, seed=0,
                   target_forward=None):
    """bench_main's serving_0p5b engine (bench.py:141-199), warmed."""
    eng = EngineConfig(verifier=VerifierConfig(method="hsd",
                                               gamma=BM.SRV_GAMMA),
                       max_new_tokens=BM.SRV_NEW, temperature=1.0)
    se = SlotEngine(cfg_s, cfg_s, eng, n_slots=n_slots,
                    bucket=BM.SRV_BUCKET, params_d=draft, params_t=small,
                    seed=seed, steps_per_dispatch=BM.SRV_MACRO,
                    admit_batch=n_slots, target_forward=target_forward,
                    device=DEV)
    se.submit(BM.SRV_WARM_RID, [5] * 40, max_new=BM.SRV_WARM_NEW)
    se.run_all()
    torch.cuda.synchronize()
    return se, eng


def serve(se, reqs):
    for rid, (p, mn) in enumerate(reqs):
        se.submit(rid, p, max_new=mn)
    done = se.run_all()
    torch.cuda.synchronize()
    return {r.rid: r for r in done}


def trunk_slot_by_slot(cfg):
    """SlotPool's target_forward protocol with the trunk run on one slot's
    rows a call (R = 1: make_generate's row count), on views of the
    pool's cache rows, so the ragged append writes the pool in place. An
    admission's prefill (lengths None) is one request's rows already."""
    def fwd(p, t, c, lengths, skip_head=False):
        if lengths is None:
            return transformer.forward(cfg, p, t, c, skip_head=skip_head)
        logits = [transformer.forward(
            cfg, p, t[b:b + 1], c.replace(k=c.k[:, b:b + 1],
                                          v=c.v[:, b:b + 1],
                                          start=c.start[b:b + 1]),
            lengths=lengths[b:b + 1], skip_head=skip_head)[0]
            for b in range(t.shape[0])]
        return torch.cat(logits), c.replace(length=c.length + t.shape[1])
    return fwd


def reference_streams(draft, small, cfg, eng, reqs, rids, seed=0):
    """make_generate on each request's bucketed prompt and the generator
    SlotEngine.submit gives it (seed << 32 plus its id), with the engine's
    budget (one cache length on both sides), cut to the request's own
    budget: {rid: tokens}."""
    gen = make_generate(cfg, cfg, eng)
    P, out = BM.SRV_BUCKET, {}
    for rid in rids:
        ids, mn = reqs[rid][0][-P:], reqs[rid][1]
        g = torch.Generator(device=DEV).manual_seed((seed << 32) + rid)
        res = gen(draft, small, torch.tensor([0] * (P - len(ids)) + ids,
                                             device=DEV), len(ids), g)
        out[rid] = res.tokens[P:res.length].tolist()[:mn]
    return out


def agreeing(ref, served):
    """The ids of the served requests whose tokens equal ref's."""
    return sorted(rid for rid, r in served.items()
                  if r.out_tokens == ref[rid])


def serving_phase(draft, target, cfg_s, trace=False):
    """Phase 5g: SlotEngine in bench.py's serving configuration on phase
    5's draft and the pair's bf16 0.5B trunk."""
    small = target.small
    reqs = BM.serving_requests(cfg_s.vocab_size)[:SERVING_REQS]
    se, eng = serving_engine(draft, small, cfg_s)
    reset_launches()
    t0 = time.perf_counter()
    served = serve(se, reqs)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    if sorted(served) != list(range(len(reqs))):
        raise AssertionError(f"serving: served {sorted(served)}")
    for rid, r in served.items():
        toks = r.out_tokens
        if not (1 <= len(toks) <= reqs[rid][1] and all(
                0 <= t < cfg_s.vocab_size for t in toks)):
            raise AssertionError(f"serving: request {rid}'s tokens {toks}")
        if not (0 <= r.accepts <= BM.SRV_GAMMA * r.blocks
                and len(toks) <= r.accepts + r.blocks):
            raise AssertionError(f"serving: request {rid}'s accepts "
                                 f"{r.accepts} over {r.blocks} blocks")
    n_tok = sum(len(r.out_tokens) for r in served.values())
    blocks = sum(r.blocks for r in served.values())
    be = (sum(r.accepts for r in served.values()) + blocks) / blocks
    log(f"serving ({len(reqs)} requests, {BM.SRV_SLOTS} slots): BE {be:.4f} "
        f"over {blocks} slot-blocks, {n_tok} tokens in {secs:.2f}s = "
        f"{n_tok / secs:.2f} tok/s; launches {counts}")
    if counts["K4"] <= 0:
        raise AssertionError("serving: K4 was not launched")
    for k in ("K1", "K2", "K3", "K8"):
        if counts[k]:
            raise AssertionError(f"serving: {k} launched")
    streams = {rid: r.out_tokens for rid, r in served.items()}
    se2, _ = serving_engine(draft, small, cfg_s)
    again = {rid: r.out_tokens for rid, r in serve(se2, reqs).items()}
    digest = hashlib.sha256(str(sorted(streams.items())).encode()
                            ).hexdigest()[:16]
    log(f"serving repeat with one seed: identical streams: "
        f"{again == streams} (sha256 {digest})")
    if again != streams:
        raise AssertionError("serving: the repeat's streams differ")
    # make_generate on each request's generator. cuBLAS rounds the bf16
    # trunk's products by row count (8 slots x 6 rows a block here, 6 in
    # make_generate), so the tokens are asserted where the trunk sees
    # make_generate's rows: the same 8-slot engine with its trunk run slot
    # by slot (every other part of the pool unchanged), a 1-slot engine;
    # and at 8 slots on the f32 image of the pair (bf16 weights, f32
    # activations, TF32 off: roundings ~1e-7, no sampled decision near
    # enough to flip). The default bf16 8-slot agreement is printed
    everyone = list(range(len(reqs)))
    ref = reference_streams(draft, small, cfg_s, eng, reqs, everyone)
    same8 = agreeing(ref, served)
    slotwise, _ = serving_engine(draft, small, cfg_s,
                                 target_forward=trunk_slot_by_slot(cfg_s))
    same_sw = agreeing(ref, serve(slotwise, reqs))
    one, _ = serving_engine(draft, small, cfg_s, n_slots=1)
    same1 = agreeing(ref, serve(one, reqs[:2]))
    cfg32 = dataclasses.replace(cfg_s, dtype=torch.float32)
    se32, eng32 = serving_engine(draft, small, cfg32)
    same32 = agreeing(reference_streams(draft, small, cfg32, eng32, reqs,
                                        [0, 1]), serve(se32, reqs[:2]))
    log(f"serving vs make_generate on each request's generator: the 8-slot "
        f"bf16 engine with its trunk run slot by slot: requests {same_sw} "
        f"of {len(reqs)} the same; of [0, 1]: 1-slot engine {same1}, 8-slot "
        f"engine in f32 {same32}; the default 8-slot bf16 engine (its "
        f"trunk over 8 slots' rows a call): {same8} (not asserted)")
    if same_sw != everyone or same1 != [0, 1] or same32 != [0, 1]:
        raise AssertionError("serving: a served request differs from "
                             "make_generate")
    same_b = {}
    for name, cfg in (("bf16", cfg_s), ("f32", cfg32)):
        same_b[name], bsecs, btoks = batched_vs_single(draft, small, cfg,
                                                       reqs)
        log(f"make_generate_batched ({name}, 4 prompts, {bsecs:.2f}s, "
            f"{btoks} tokens): rows {same_b[name]} of [0, 1, 2, 3] equal "
            f"make_generate on their generators"
            + (" (not asserted)" if name == "bf16" else ""))
    if same_b["f32"] != [0, 1, 2, 3]:
        raise AssertionError("make_generate_batched != make_generate")
    if trace:
        trace_serving(draft, small, cfg_s, reqs)
    return dict(be=be, tok_s=n_tok / secs, tokens=n_tok, blocks=blocks,
                secs=secs, counts=counts, sha=digest, same8=same8,
                same_slotwise=same_sw, same_batched=same_b["bf16"])


def batched_vs_single(draft, small, cfg, reqs):
    """make_generate_batched on the first 4 requests' prompts against
    make_generate on each one's generator: the rows that agree, the
    batched call's seconds and tokens."""
    eng = EngineConfig(verifier=VerifierConfig(method="hsd",
                                               gamma=BM.SRV_GAMMA),
                       max_new_tokens=BM.SRV_NEW, temperature=1.0)
    P = BM.SRV_BUCKET
    prompts = torch.stack([torch.tensor(([0] * P + reqs[i][0])[-P:],
                                        device=DEV) for i in range(4)])
    plens = [len(reqs[i][0]) for i in range(4)]
    t0 = time.perf_counter()
    bres = make_generate_batched(cfg, cfg, eng)(
        draft, small, prompts, plens,
        [torch.Generator(device=DEV).manual_seed(60 + i) for i in range(4)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    gen = make_generate(cfg, cfg, eng)
    same = []
    for i in range(4):
        res = gen(draft, small, prompts[i], plens[i],
                  torch.Generator(device=DEV).manual_seed(60 + i))
        n = int(bres.length[i])
        if n == res.length and torch.equal(bres.tokens[i, :n],
                                           res.tokens[:n]):
            same.append(i)
    return same, secs, int(bres.ncommit.sum())


def trace_serving(draft, small, cfg_s, reqs):
    """Where a serving pool's time goes: the 5g run again with each part
    timed on the host clock between synchronizes (so the parts sum past
    the untimed run): pool blocks, their draft and target forwards, the
    vmapped verifier, the noise draws, the admissions' prefills; then one
    pool block of 8 live slots under the profiler (device time by kernel,
    idle share, ops)."""
    from torch.profiler import ProfilerActivity, profile
    import hsd_tpu_torch.engine.speculative as SP
    spent, calls = {}, {}

    def timed_part(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + (time.perf_counter() - t0)
            calls[name] = calls.get(name, 0) + 1
            return out
        return run

    se, _ = serving_engine(draft, small, cfg_s)
    pool, fwd = se.pool, SP.transformer.forward

    def forward(cfg, p, t, c, **k):
        part = ("prefill forward" if k.get("lengths") is None else
                "target forward" if t.shape[1] == BM.SRV_GAMMA + 1
                else "draft forward")
        return timed_part(part, fwd)(cfg, p, t, c, **k)

    for name in ("block", "prefill", "_verify", "_draft_noise",
                 "_verify_noise"):
        setattr(pool, name, timed_part(name.strip("_"), getattr(pool, name)))
    SP.transformer.forward = forward
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocks0 = se.pool_blocks
        serve(se, reqs)
        wall = time.perf_counter() - t0
    finally:
        SP.transformer.forward = fwd
    log(f"trace serving ({len(reqs)} requests, parts timed apart): wall "
        f"{wall * 1e3:.1f} ms, {se.pool_blocks - blocks0} pool blocks; "
        + "; ".join(f"{n} {spent[n] * 1e3:.1f} ms over {calls[n]} "
                    f"({spent[n] * 1e3 / calls[n]:.2f} each)"
                    for n in sorted(spent)))
    se, _ = serving_engine(draft, small, cfg_s)
    for rid, (p, mn) in enumerate(reqs[:BM.SRV_SLOTS]):
        se.submit(rid, p, max_new=mn)
    se._admit()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        se._pool_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    log(f"trace serving (one pool block, {BM.SRV_SLOTS} live slots, under "
        f"the profiler): wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}, "
        f"{sum(r[1] for r in rows)} device ops")
    for dev_us, count, key in rows[:8]:
        log(f"  {dev_us / 1e3:9.3f} ms  x{count:<6} {key[:90]}")


class CharTok:
    """The toy char-level tokenizer of tests/test_uad.py: one letter a
    token, ids 0-25."""

    def decode(self, ids):
        return "".join(chr((int(i) % 26) + 97) for i in ids)

    def encode(self, s):
        return [ord(c) - 97 for c in s if "a" <= c <= "z"]


def uad_drafter():
    """tests/test_uad.py's drafter: continue the text by repeating its
    last three letters."""
    tok = CharTok()
    return tok, UadDrafter(tok, tok, lambda text, n: text[-3:][:n],
                           chars_per_token=1)


def uad_phase(target, cfg_b):
    """Phase 5h: UAD on the 48-layer 14B int4 trunk."""
    tok, drafter = uad_drafter()
    eng = EngineConfig(verifier=VerifierConfig(method="tokenwise",
                                               gamma=UAD_GAMMA),
                       max_new_tokens=UAD_NEW, temperature=1.0)
    prompt = tok.encode("thecatsatonthematandthedogsatonthelog" * 2)[:BUCKET]
    gen = make_uad_generate(cfg_b, eng, drafter, device=DEV)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = gen(target.big, prompt, torch.Generator(device=DEV).manual_seed(9))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    log(f"uad (14B int4 trunk, gamma {UAD_GAMMA}): {len(out)} tokens in "
        f"{secs:.2f}s = {len(out) / secs:.2f} tok/s, of them "
        f"{sum(0 <= t < 26 for t in out)} letters; launches {counts}")
    if not (1 <= len(out) <= UAD_NEW
            and all(0 <= t < cfg_b.vocab_size for t in out)):
        raise AssertionError(f"uad: bad stream {out}")
    for k in ("K1", "K2", "K3"):
        if counts[k] <= 0:
            raise AssertionError(f"uad: {k} was not launched")
    if counts["K8"]:
        raise AssertionError("uad: K8 launched on the default path")
    return dict(tokens=len(out), secs=secs, counts=counts)


def eval_phase(draft, target, cfg_s, cfg_b):
    """Phase 5i: the GSM8K harness and the multi-bench driver on phase 5's
    full-width pair."""
    from hsd_tpu_torch.eval.benches import (load_bench_questions,
                                            reorg_answer_file, run_multibench)
    from hsd_tpu_torch.eval.eagle_metrics import evaluate_info_file
    from hsd_tpu_torch.eval.gsm8k import (ByteTokenizer, EvalConfig,
                                          build_prompt, bucket_pad,
                                          default_prompt_path,
                                          load_gsm8k_jsonl, prompt_tensor,
                                          question_generator, run_eval)

    fwd, ops = make_coupled_target(cfg_s, cfg_b)
    tok = ByteTokenizer()
    with open(default_prompt_path("original")) as f:
        shots = f.read()
    qs = load_gsm8k_jsonl(os.path.join(REPO, "data", "gsm8k",
                                       "question.jsonl"), stride=1)
    padded, n = bucket_pad(tok.encode(build_prompt(qs[0]["question"],
                                                   shots)))
    P = padded.shape[0]
    if (P, n) != (2048, 2048):
        raise AssertionError(f"eval: question 0 landed in bucket {P}, n {n}")
    prompt = prompt_tensor(padded, DEV)
    S = P + EVAL_NEW + GAMMA + 2
    start = torch.zeros((1,), dtype=torch.int64, device=DEV)
    prefill = {}
    for name, call in (
            ("target", lambda: fwd(target, prompt[None, :-1],
                                   ops[0](1, S, start.clone(), DEV),
                                   skip_head=True)),
            ("draft", lambda: transformer.forward(
                cfg_s, draft, prompt[None, :-2],
                init_cache(cfg_s, 1, S, DEV), skip_head=True))):
        call()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        launched = {k: v for k, v in launch_counts().items() if v}
        nrows = P - (1 if name == "target" else 2)
        prefill[name] = dict(rows=nrows, ms=ms, peak_gib=peak)
        log(f"eval: {name} prefill of a GSM8K prompt ({nrows} rows, route "
            f"A): {ms:.2f} ms, peak {peak:.3f} GiB above the allocated, "
            f"kernel launches {launched or 'none'}")

    eng = EngineConfig(verifier=VerifierConfig(method="hsd", gamma=GAMMA,
                                               num_drafts=1),
                       max_new_tokens=EVAL_NEW, temperature=1.0)
    with tempfile.TemporaryDirectory() as tmp:
        ev = EvalConfig(engine=eng, out_dir=tmp, tag="hsd14b", seed=0)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        summary = run_eval(cfg_s, cfg_b, draft, target, tok, qs, shots, ev,
                           target_forward=fwd, target_cache_ops=ops,
                           device=DEV)
        secs = time.perf_counter() - t0
        counts = launch_counts()
        with open(summary["artifacts"]["counts"]) as f:
            rows = json.load(f)
        with open(summary["artifacts"]["answers"]) as f:
            answers = f.read()
    keys = {"accepts", "draft_lens", "time_s", "new_tokens", "draft_eval",
            "sample_length", "target_eval", "total_step", "time", "ids"}
    if len(rows) != len(qs) or answers.count("\nA_model:\n") != len(qs):
        raise AssertionError("eval: artifacts miss a question")
    for r in rows:
        nb = len(r["accepts"])
        if set(r) != keys or not (
                1 <= r["new_tokens"] <= EVAL_NEW
                and len(r["ids"][0]) == r["new_tokens"]
                and r["draft_lens"] == [GAMMA] * nb
                and all(0 <= a <= GAMMA for a in r["accepts"])
                and r["sample_length"] == [[a + 1 for a in r["accepts"]]]
                and r["target_eval"] == [[1] * nb]
                and r["draft_eval"] == [r["draft_lens"]]):
            raise AssertionError(f"eval: a counts row's shape: {sorted(r)}")
    acc = [a for r in rows for a in r["accepts"]]
    be = statistics.fmean(a + 1 for a in acc)
    if abs(summary["block_efficiency"] - be) > 1e-9:
        raise AssertionError(f"eval: summarize's BE "
                             f"{summary['block_efficiency']} vs {be}")
    for k in SPEC_KERNELS:
        if counts[k] <= 0:
            raise AssertionError(f"eval: {k} was not launched")
    if counts["K8"]:
        raise AssertionError("eval: K8 launched on the default path")
    res = make_generate(cfg_s, cfg_b, eng, target_forward=fwd,
                        target_cache_ops=ops)(
        draft, target, prompt, n, question_generator(0, 0, DEV))
    direct = res.tokens[P:res.length].tolist()
    if direct != rows[0]["ids"][0]:
        raise AssertionError("eval: question 0's tokens differ from "
                             "make_generate's on its generator")
    log(f"eval (GSM8K, {len(qs)} questions x {EVAL_NEW} tokens, hsd, 14B): "
        f"BE {summary['block_efficiency']:.4f} (the mean of accepts + 1 "
        f"over {len(acc)} blocks), {summary['decoding_speed']:.2f} tok/s "
        f"by the reference's DS, {secs:.2f}s in all; question 0 == "
        f"make_generate on its generator ({len(direct)} tokens): True; "
        f"launches {counts}")

    bench_rows = []
    for bi, b in enumerate(EVAL_BENCHES):
        q = load_bench_questions(b, os.path.join(REPO, "data", b,
                                                 "question.jsonl"))[0]
        bench_rows.append(dict(q, question_id=100 * bi + q["question_id"]))
    bench_rows.reverse()
    beng = EngineConfig(verifier=VerifierConfig(method="hsd", gamma=GAMMA),
                        max_new_tokens=EVAL_BENCH_NEW, temperature=1.0)
    bgen = make_generate(cfg_s, cfg_b, beng, target_forward=fwd,
                         target_cache_ops=ops)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = run_multibench(bench_rows, tok,
                             lambda p, n, g: bgen(draft, target, p, n, g),
                             tmp, "eight", warmup=1, device=DEV)
        bsecs = time.perf_counter() - t0
        m = evaluate_info_file(out["info"], gamma=GAMMA)
        reorg_answer_file(out["answers"])
        with open(out["answers"]) as f:
            ids = [json.loads(l)["question_id"] for l in f if l.strip()]
    want = sorted(r["question_id"] for r in bench_rows)
    if m is None or m["questions"] != 8 or ids != want:
        raise AssertionError(f"eval: multi-bench rows {m} ids {ids}")
    log(f"eval (multi-bench, 8 benches' first rows, hsd, {EVAL_BENCH_NEW} "
        f"tokens a turn): {out['new_tokens']} tokens in {bsecs:.2f}s; "
        f"evaluate_info_file BE {m['block_efficiency']:.4f} over "
        f"{m['questions']} rows; reorg_answer_file order {ids}")
    return dict(prefill=prefill, be=summary["block_efficiency"], secs=secs,
                counts=counts, bench_be=m["block_efficiency"])


TRAIN_WORDS = ("the model drafts tokens and the target verifies them in one "
               "forward pass so the output keeps its law while the speed "
               "grows with every accepted token of a longer draft").split()


def train_conversations(n, user, reply, seed):
    """n chats (system, user, assistant) with user[0]..user[1] words in the
    question and reply[0]..reply[1] in the answer, drawn from a seeded
    numpy generator."""
    rng = np.random.default_rng(seed)

    def text(lo, hi):
        return " ".join(rng.choice(TRAIN_WORDS, int(rng.integers(lo, hi))))
    return [[{"role": "system", "content": "Be brief."},
             {"role": "user", "content": text(*user)},
             {"role": "assistant", "content": text(*reply)}]
            for _ in range(n)]


def expect_only_k7(label, counts):
    """K7 launched, every other kernel not."""
    bad = {k: v for k, v in counts.items() if (v > 0) != (k == "K7")}
    if bad:
        raise AssertionError(f"{label}: launches {counts}")


def train_step_parts(step, state, trunk, ids, lm):
    """One more train step with each part run alone, a synchronize before
    and after it: {part: ms} and the step's total ms."""
    from hsd_tpu_torch.train import eagle3 as E3
    parts = {}

    def timed(name, fn):
        def f(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + 1e3 * (time.perf_counter()
                                                        - t0)
            return out
        return f

    saved = (E3.target_stream, E3.multi_step_head_loss,
             E3.clip_by_global_norm_, torch.Tensor.backward, state.opt.step)
    E3.target_stream = timed("target forward", saved[0])
    E3.multi_step_head_loss = timed("head forward", saved[1])
    E3.clip_by_global_norm_ = timed("clip", saved[2])
    torch.Tensor.backward = timed("head backward", saved[3])
    state.opt.step = timed("AdamW", saved[4])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, trunk, ids, lm)
        float(m["loss"])
        total = 1e3 * (time.perf_counter() - t0)
    finally:
        (E3.target_stream, E3.multi_step_head_loss, E3.clip_by_global_norm_,
         torch.Tensor.backward, state.opt.step) = saved
    return parts, total


def tamed(params):
    """The trunk's int8 codes with each layer product's scales over
    sqrt(in), so its layer inputs stay inside f16's range; the head keeps
    its scales, so the logits keep their spread (few near-ties for f16 to
    flip)."""
    def t(w):
        if not isinstance(w, QuantizedLinear):
            return w
        return w._replace(scales=(w.scales.float() / math.sqrt(w.din))
                          .to(w.scales.dtype))
    return params._replace(layers={k: t(v) for k, v in params.layers.items()})


def offline_round(cfg, ecfg, tc, trunk, head, ids, lm, fl, label):
    """dump_features of one batch into a temporary directory, the shard read
    back, then 3 offline steps from `head`: sizes, the shard's non-finite
    share and largest magnitudes, the losses."""
    from hsd_tpu_torch.train import eagle3 as E3
    from hsd_tpu_torch.train.features import (dump_features,
                                              offline_data_epochs)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        dump_features(cfg, trunk, [(ids, lm)], d, feature_layers=fl,
                      version=3, device=DEV)
        dump_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        batch = next(iter(offline_data_epochs(d, device=DEV)(0)))
    f, lg = batch["features"], batch["target_logits"]
    out = dict(bytes=size, dump_s=dump_s,
               nonfinite=float((~torch.isfinite(f)).float().mean()
                               + (~torch.isfinite(lg)).float().mean()),
               feats_max=float(f[torch.isfinite(f)].abs().max()),
               logits_max=float(lg[torch.isfinite(lg)].abs().max()))
    state = E3.init_train_state(head, tc)
    ostep = E3.make_train_step_offline(cfg, ecfg, tc)
    out["losses"] = [float(ostep(state, None, **batch)[1]["loss"])
                     for _ in range(3)]
    log(f"train: dump_features on {label}: {size} bytes in {dump_s:.2f}s; "
        f"non-finite share {out['nonfinite']:.4f}, largest finite |feats| "
        f"{out['feats_max']:.1f}, |logits| {out['logits_max']:.1f}; offline "
        f"losses {out['losses']}")
    return out


def train_phase(trunk, cfg):
    """Phase 18: EAGLE head training over the frozen int8 8B trunk."""
    from hsd_tpu_torch.eval.benches import ChatTemplate
    from hsd_tpu_torch.eval.gsm8k import ByteTokenizer
    from hsd_tpu_torch.models.eagle import init_eagle_params_v1
    from hsd_tpu_torch.train import eagle1 as E1
    from hsd_tpu_torch.train import eagle3 as E3
    from hsd_tpu_torch.train.data import conversation_batches
    from hsd_tpu_torch.train.draft_vocab import build_draft_vocab, count_tokens
    from hsd_tpu_torch.train.probes import make_kacc_probe
    from hsd_tpu_torch.engine.eagle_engine import default_feature_layers

    fl = default_feature_layers(cfg)
    tok, tmpl = ByteTokenizer(), ChatTemplate(style="llama3")
    batches = list(conversation_batches(
        train_conversations(8, (15, 25), (80, 110), 18), tok, TRAIN_B, tmpl,
        max_len=TRAIN_T, buckets=(TRAIN_T,), seed=18))
    long_ids, long_lm = next(iter(conversation_batches(
        train_conversations(1, (30, 40), (380, 420), 19), tok, 1, tmpl,
        max_len=TRAIN_LONG, buckets=(TRAIN_LONG,), seed=19)))
    ids, lm = batches[0]
    if ids.shape != (TRAIN_B, TRAIN_T) or long_ids.shape != (1, TRAIN_LONG):
        raise AssertionError(f"train: batch shapes {ids.shape} "
                             f"{long_ids.shape}")
    counts_v = count_tokens([b[0] for b in batches] + [long_ids],
                            cfg.vocab_size)
    with tempfile.TemporaryDirectory() as d:
        with open(f"{d}/config.json", "w") as f:
            json.dump(EAGLE3_CONFIG, f)
        ecfg = EagleConfig.from_json(f"{d}/config.json")
    d2t, t2d = build_draft_vocab(counts_v, ecfg.draft_vocab_size)
    vocab = dict(d2t=torch.from_numpy(d2t).long().to(DEV),
                 t2d=torch.from_numpy(t2d).to(DEV))
    head = init_eagle_params(ecfg, seed=18, device=DEV)._replace(**vocab)
    tc = E3.TrainConfig(**TRAIN_TC)
    log(f"train: {len(batches)} batches of {TRAIN_B} x {TRAIN_T} "
        f"({int(lm.sum())} of {lm.size} positions train), draft vocabulary "
        f"{int(t2d.sum())} of {cfg.vocab_size} ({int((counts_v > 0).sum())} "
        f"ids seen); the head {ecfg.hidden_size} wide, bf16, {tc}")

    # online EAGLE-3 steps on one repeated batch
    state = E3.init_train_state(head, tc)
    step = E3.make_train_step(cfg, ecfg, tc, fl)
    frozen0 = {k: getattr(head, k).clone() for k in E3.FROZEN}
    wq0 = state.params.wq.detach().clone()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, secs = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, trunk, ids, lm)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
        if i == 0 and not torch.equal(state.params.wq, wq0):
            raise AssertionError("train: step 0 (lr 0) moved a weight")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    out = dict(losses=losses, counts=counts, step_s=secs,
               base_gib=base / 2**30, peak_gib=peak / 2**30,
               k7_per_forward=counts["K7"] / TRAIN_STEPS,
               acc=[float(m[f"acc_{i}"]) for i in range(tc.steps)])
    out["step_ms"] = 1e3 * statistics.mean(secs[2:])
    out["tok_s"] = TRAIN_B * TRAIN_T / statistics.mean(secs[2:])
    log(f"train: EAGLE-3 losses {[round(x, 4) for x in losses]}; step ms "
        f"{[round(1e3 * x, 2) for x in secs]}; {out['tok_s']:.1f} tokens/s "
        f"trained (steps 2..{TRAIN_STEPS - 1}); peak {out['peak_gib']:.2f} "
        f"GiB ({out['base_gib']:.2f} before the steps); launches {counts} "
        f"({out['k7_per_forward']} K7 a target forward); acc_i after "
        f"{[round(x, 4) for x in out['acc']]}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[1]:
        raise AssertionError(f"train: losses {losses}")
    for k in E3.FROZEN:
        if not torch.equal(getattr(state.params, k), frozen0[k]):
            raise AssertionError(f"train: frozen {k} changed")
    expect_only_k7("train: EAGLE-3 steps", counts)
    parts, total = train_step_parts(step, state, trunk, ids, lm)
    out["parts_ms"], out["parts_total_ms"] = parts, total
    log(f"train: one step with its parts run alone, {total:.2f} ms: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items())
        + f" (the rest {total - sum(parts.values()):.2f} ms)")

    # one step at the reference's max_len: every product on route A
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state, m = step(state, trunk, long_ids, long_lm)
    long_loss = float(m["loss"])
    out["long_ms"] = 1e3 * (time.perf_counter() - t0)
    out["long_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    long_counts = launch_counts()
    log(f"train: one 1 x {TRAIN_LONG} step {out['long_ms']:.2f} ms, loss "
        f"{long_loss:.4f}, peak {out['long_peak_gib']:.2f} GiB, launches "
        f"{long_counts}")
    if not math.isfinite(long_loss) or any(long_counts.values()):
        raise AssertionError("train: the 2048-row step")

    # offline features. The trunk's layer inputs outgrow f16 (random int8
    # codes at scales ~1e-2 with no 1/sqrt(fan-in)): its shard is dumped and
    # its non-finite share read; the agreement with the online steps is
    # checked on the same codes with every layer's scales over sqrt(in),
    # with a head over the full vocabulary (that trunk's argmax lands
    # outside the 32000 drafted ids, which would mask every position)
    out["raw_shard"] = offline_round(cfg, ecfg, tc, trunk, head, ids, lm,
                                     fl, "the trunk")
    tame = tamed(trunk)
    fcfg = dataclasses.replace(ecfg, draft_vocab_size=cfg.vocab_size)
    fhead = init_eagle_params(fcfg, seed=20, device=DEV)
    tstate = E3.init_train_state(fhead, tc)
    fstep = E3.make_train_step(cfg, fcfg, tc, fl)
    tl = [float(fstep(tstate, tame, ids, lm)[1]["loss"]) for _ in range(3)]
    del tstate
    shard = offline_round(cfg, fcfg, tc, tame, fhead, ids, lm, fl,
                          "the scaled trunk")
    # the online loss on the shard's f16 image of the online inputs
    ids_t = torch.from_numpy(ids).long().to(DEV)
    lm_t = torch.from_numpy(lm).to(DEV)
    logits, feats = E3.target_stream(cfg, tame, ids_t, fl)
    half = lambda t: t.half().float()
    flips = int((logits.argmax(-1) != half(logits).argmax(-1)).sum())
    with torch.no_grad():
        ref = float(E3.multi_step_head_loss(
            fcfg, fhead, half(feats), E3._shift(half(logits)),
            E3._shift(ids_t), lm_t, tc.steps)[0])
    del logits, feats, fhead
    if not ref > 0:
        raise AssertionError(f"train: the scaled trunk's loss {ref}")
    exact = abs(shard["losses"][0] - ref) / ref
    rel = max(abs(a - b) / abs(b) for a, b in zip(shard["losses"], tl))
    out.update(offline_losses=shard["losses"], tamed_losses=tl,
               offline_rel=rel, offline_exact=exact, f16_flips=flips,
               shard=shard)
    log(f"train: the scaled trunk's online losses {tl}, offline "
        f"{shard['losses']}: max relative difference {rel:.2e} (bound "
        f"{OFFLINE_RTOL}; {flips} of {ids.size} target argmaxes move under "
        f"f16); offline step 0 vs the online loss on the f16-rounded inputs "
        f"{exact:.2e} (bound {EXACT_RTOL})")
    if shard["nonfinite"] or exact > EXACT_RTOL or rel > OFFLINE_RTOL:
        raise AssertionError("train: offline vs online")

    # EAGLE-1: phase 9's v1 head geometry over the final hidden state
    _, ecfg1 = BM.eagle_configs()
    head1 = init_eagle_params_v1(ecfg1, seed=19, device=DEV)._replace(
        **vocab)
    s1 = E3.init_train_state(head1, tc)
    step1 = E1.make_eagle1_train_step(cfg, ecfg1, tc)
    reset_launches()
    t0 = time.perf_counter()
    l1 = [float(step1(s1, trunk, ids, lm)[1]["loss"]) for _ in range(3)]
    e1_s = time.perf_counter() - t0
    c1 = launch_counts()
    out["eagle1_losses"] = l1
    log(f"train: EAGLE-1 losses {l1} in {e1_s:.2f}s; launches {c1}")
    if not all(math.isfinite(x) for x in l1):
        raise AssertionError("train: EAGLE-1 losses")
    expect_only_k7("train: EAGLE-1 steps", c1)
    del s1, head1, step1

    # the rollout probe
    t0 = time.perf_counter()
    kacc = make_kacc_probe(cfg, ecfg)(state.params, trunk, ids, lm)
    out["kacc"] = {k: round(v, 4) for k, v in kacc.items()}
    log(f"train: kacc probe {out['kacc']} in "
        f"{time.perf_counter() - t0:.2f}s")
    if len(kacc) != 5 or not all(0.0 <= v <= 1.0 for v in kacc.values()):
        raise AssertionError(f"train: kacc {kacc}")

    # a checkpoint round trip at full width
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        E3.save_checkpoint(d, state)
        out["ckpt_save_s"] = time.perf_counter() - t0
        out["ckpt_bytes"] = sum(
            os.path.getsize(os.path.join(r, f))
            for r, _, fs in os.walk(d) for f in fs)
        t0 = time.perf_counter()
        back = E3.restore_checkpoint(d, state.step,
                                     E3.init_train_state(head, tc))
        torch.cuda.synchronize()
        out["ckpt_restore_s"] = time.perf_counter() - t0
    same = back.step == state.step and all(
        torch.equal(p, q) and all(
            torch.equal(state.opt.state[p][k], back.opt.state[q][k])
            for k in ("exp_avg", "exp_avg_sq"))
        for (_, p), (_, q) in zip(E3.trainable_leaves(state.params),
                                  E3.trainable_leaves(back.params)))
    log(f"train: checkpoint at step {state.step}: {out['ckpt_bytes']} bytes,"
        f" saved in {out['ckpt_save_s']:.2f}s, restored in "
        f"{out['ckpt_restore_s']:.2f}s; params and Adam moments bit-equal: "
        f"{same}")
    if not same:
        raise AssertionError("train: the checkpoint round trip")
    del state, back, head
    torch.cuda.empty_cache()
    return out


def oracle_phase():
    """Phase 17: the realistic row's trained pair on the card, cut to
    ORACLE_STEPS steps each."""
    from hsd_tpu_torch.eval.oracle import (distill_lm, make_language,
                                           ratio_stats, sample_tokens,
                                           train_lm)
    from hsd_tpu_torch.ops.sampling import fold_generator, fold_seed

    cfg_t, cfg_d = BM.realistic_configs()
    lang = make_language(BM.REAL_LANG_SEED, vocab=cfg_t.vocab_size,
                         device=DEV)
    torch.cuda.synchronize()
    reset_launches()
    out = {}
    t0 = time.time()
    tl, dl = [], []
    pt, tce = train_lm(cfg_t, fold_seed(BM.REAL_SEED, 32), lang,
                       steps=ORACLE_STEPS, device=DEV, losses=tl)
    out["train_s"] = time.time() - t0
    t0 = time.time()
    pd, dce = distill_lm(cfg_d, cfg_t, pt, fold_seed(BM.REAL_SEED, 33), lang,
                         steps=ORACLE_STEPS, device=DEV, losses=dl)
    out["distill_s"] = time.time() - t0
    log(f"oracle: target CE {tl[0]:.4f} -> {tce:.4f} over {ORACLE_STEPS} "
        f"steps ({out['train_s']:.1f}s), draft soft CE {dl[0]:.4f} -> "
        f"{dce:.4f} ({out['distill_s']:.1f}s)")
    if not (math.isfinite(tce) and math.isfinite(dce) and tce < tl[0]
            and dce < dl[0]):
        raise AssertionError("oracle: a loss did not fall")
    st = ratio_stats(cfg_d, cfg_t, pd, pt, lang,
                     fold_generator(BM.REAL_SEED, 35, device=DEV),
                     gamma=GAMMA)
    log(f"oracle ratio_stats: {st}")
    prompts = sample_tokens(fold_generator(BM.REAL_SEED, 34, device=DEV),
                            lang, 8, 64)
    for m in ("tokenwise", "hsd"):
        gen = make_generate(cfg_d, cfg_t, EngineConfig(
            verifier=VerifierConfig(method=m, gamma=GAMMA),
            max_new_tokens=ORACLE_NEW))
        t0 = time.perf_counter()
        res = gen(pd, pt, prompts[0], 64,
                  fold_generator(BM.REAL_SEED, 700, device=DEV))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        acc = res.accepts[:res.blocks]
        toks = res.tokens[64:res.length]
        if not (1 <= res.ncommit <= ORACLE_NEW and int(toks.min()) >= 0
                and int(toks.max()) < cfg_t.vocab_size
                and int(acc.min()) >= 0 and int(acc.max()) <= GAMMA):
            raise AssertionError(f"oracle: {m} stream out of range")
        out[m] = float((acc + 1).float().mean())
        log(f"oracle {m}: {res.ncommit} tokens in {secs:.2f}s, BE "
            f"{out[m]:.4f} over {res.blocks} blocks")
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"oracle: a kernel launched on dense f32 "
                             f"models: {counts}")
    out.update(target_ce=tce, distill_ce=dce, alpha=st["alpha"],
               counts=counts)
    return out


def long_context_phase(target, cfg_b):
    """ms per decode step of the 48-layer 14B int4 trunk at long caches, by
    the einsum path and by K8 (scripts/bench_longctx.py's counterpart)."""
    big = target.big
    rows = []
    reset_launches()

    def step_ms(toks, cache):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LONG_ITERS):
            transformer.forward(cfg_b, big, toks, cache)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / LONG_ITERS * 1e3

    for L in LONG_LENS:
        cache = init_cache(cfg_b, 1, L + 64, DEV).replace(length=L)
        for T in (1, 11):
            toks = torch.full((1, T), 11, device=DEV)
            times = {"einsum": [], "K8": []}
            # in turns (einsum, K8, K8, einsum), each after two warm steps
            for mode in ("einsum", "K8", "K8", "einsum"):
                with (opted_in("FLASH_DECODE") if mode == "K8"
                      else contextlib.nullcontext()):
                    for _ in range(2):
                        transformer.forward(cfg_b, big, toks, cache)
                    times[mode].append(step_ms(toks, cache))
            row = dict(len=L, T=T, **{m: statistics.mean(v)
                                       for m, v in times.items()},
                       runs=times)
            rows.append(row)
            log(f"long context L={L} T={T}: einsum {row['einsum']:.3f} "
                f"ms/step, K8 {row['K8']:.3f} ms/step "
                f"({row['einsum'] / row['K8']:.3f}x; runs {times})")
        del cache
    counts = launch_counts()
    if counts["K8"] <= 0:
        raise AssertionError("long context: K8 was not launched")
    return dict(rows=rows, counts=counts)


def eagle_single(target, head, cfg, ecfg):
    """make_eagle_generate at full width with FLASH_DECODE on: the tree
    forward runs K8 with its [T, T] bias."""
    fwd = make_coupled_eagle_target(cfg, (-1,))
    rng = np.random.default_rng(1)
    prompt = torch.tensor(rng.integers(10, 1000, (64,)), device=DEV)
    gen = make_eagle_generate(cfg, ecfg, EngineConfig(max_new_tokens=64,
                                                      temperature=1.0),
                              mode="hsd_ref", target_forward=fwd)
    with opted_in("FLASH_DECODE"):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = gen(target, head, prompt, 64,
                  torch.Generator(device=DEV).manual_seed(2))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
    toks = res.tokens[64:res.length].tolist()
    if not toks or not all(0 <= t < cfg.vocab_size for t in toks):
        raise AssertionError("eagle single request: bad stream")
    be = float((res.accepts[:res.blocks].float() + 1).mean())
    log(f"eagle single request, FLASH_DECODE = always: {res.ncommit} tokens "
        f"in {res.blocks} blocks, BE {be:.4f}, {res.ncommit / secs:.2f} "
        f"tok/s; launches {counts}")
    if counts["K8"] <= 0:
        raise AssertionError("eagle single request: K8 was not launched")
    return dict(be=be, tok_s=res.ncommit / secs, counts=counts)


def greedy_k8():
    """2-layer float32 pairs, head_dim 64, caches of >= 128 slots: under
    each K8 mode every engine's greedy stream equals AR, with K8 counted
    around the engine and around its AR baseline apart. Each engine and
    each baseline launches K8, but for EAGLE under FUSED_ATTN: its tree
    keeps the einsum route, as in the JAX package, and must launch none."""
    cfg = ModelConfig.tiny(vocab_size=512, hidden_size=256,
                           intermediate_size=512, num_heads=4,
                           num_kv_heads=2, dtype=torch.float32,
                           eos_token_id=10**9)
    draft = quantize_draft(cfg, fuse_params(cfg, init_params(cfg, seed=5,
                                                             device=DEV)))
    target = init_quantized_params(cfg, seed=6, bits=4, device=DEV)
    ecfg_cfg = dataclasses.replace(cfg, attention_bias=False,
                                   tie_word_embeddings=False)
    ecfg = EagleConfig(hidden_size=256, target_hidden_size=256, num_heads=4,
                       num_kv_heads=2, vocab_size=512, draft_vocab_size=384,
                       intermediate_size=512, rope_theta=cfg.rope_theta,
                       top_k=4, depth=3, total_tokens=11,
                       dtype=torch.float32, version=1)
    head, etarget = build_coupled_eagle_pair(5, ecfg_cfg, ecfg, scale=4.0,
                                             lam=1.0, big_bits=8, device=DEV)
    efwd = make_coupled_eagle_target(ecfg_cfg, (-1,))
    P, plen = 112, 106
    prompt = (torch.arange(P, device=DEV) % 37) + 3
    eng = EngineConfig(verifier=VerifierConfig(method="greedy", gamma=4),
                       max_new_tokens=32, temperature=0.0)

    def ar(params, c, fwd=None):
        toks, length = make_autoregressive(c, eng, model_forward=fwd)(
            params, prompt, plen, None)
        return toks[P:length].tolist()

    def ar_eagle():
        return ar(etarget, ecfg_cfg, lambda p, t, c, skip_head=False:
                  efwd(p, t, c, None, None)[:2])

    # name: (AR baseline, engine run)
    checks = {
        "spec": (lambda: ar(target, cfg), lambda: make_generate(
            cfg, cfg, eng)(draft, target, prompt, plen, None)),
        "stepwise": (lambda: ar(target, cfg), lambda: make_stepwise_generate(
            cfg, cfg, eng)(draft, target, prompt, plen, None)),
        "recursive": (lambda: ar(target, cfg),
                      lambda: make_recursive_generate(cfg, cfg, eng)(
                          draft, target, prompt, plen, None)),
        "prompt lookup": (lambda: ar(target, cfg),
                          lambda: make_prompt_lookup_generate(cfg, eng)(
                              target, prompt, plen, None)),
        "eagle": (ar_eagle, lambda: make_eagle_generate(
            ecfg_cfg, ecfg, eng, mode="greedy", target_forward=efwd)(
                etarget, head, prompt, plen, None)),
    }

    def k8_launches(fn):
        before = launch_counts()["K8"]
        out = fn()
        return out, launch_counts()["K8"] - before

    for attr in ("FUSED_ATTN", "FLASH_DECODE"):
        with opted_in(attr):
            for name, (ar_fn, engine_fn) in checks.items():
                want, ar_used = k8_launches(ar_fn)
                res, used = k8_launches(engine_fn)
                got = res[0][P:res[1]].tolist()    # (tokens, length, ...)
                if got != want or len(got) < 32:
                    raise AssertionError(f"{attr}: greedy {name} != AR:\n"
                                         f"{got}\n{want}")
                # the EAGLE tree's forwards carry a bias, which the fused
                # route does not take (as in the JAX package): under
                # FUSED_ATTN only its AR baseline runs K8
                einsum_only = name == "eagle" and attr == "FUSED_ATTN"
                if ar_used <= 0 or (used <= 0) != einsum_only:
                    raise AssertionError(
                        f"{attr}: greedy {name} K8 launches {used}, its AR "
                        f"baseline's {ar_used}")
                route = ("its tree stays on the einsum route"
                         if einsum_only else f"K8 launches {used}")
                log(f"greedy K8 {attr}: {name} == AR ({len(got)} tokens; "
                    f"{route}; the AR baseline's K8 launches {ar_used})")


def summary_entry(name, label, n, source, replaces, launches):
    rows = [r for r in KERNEL_ROWS if r["name"] == name]
    if not rows:
        raise AssertionError(f"{name}: no measured row")
    rep = next(r for r in rows if r["label"] == label and r["n"] == n)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"] if name not in ("K2", "K6")
            else None,
            "shape": f"{label}, {n} rows"}


def device_rows(prof):
    """(device us, launches, kernel name) per kernel name, largest first."""
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    return rows


def trace_window(gen, draft, target, prompt):
    """Where the time goes: one short hsd generate under torch.profiler.
    Device time by kernel, the wall time, and the device's idle share
    (1 - device busy / wall; one stream, so kernels do not overlap). The
    profiler's own host cost lengthens the wall, so the idle share is an
    upper bound."""
    from torch.profiler import ProfilerActivity, profile
    # device activity only: CPU-op aggregates would count kernels twice
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = gen(draft, target, prompt, BUCKET,
                  torch.Generator(device=DEV).manual_seed(9))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    ours = sum(r[0] for r in rows if any(
        k in r[2] for k in ("i8_kernel", "prep_kernel", "splitk_epilogue")))
    k8 = sum(r[0] for r in rows if "flash_" in r[2])
    out = dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
               idle_share=1 - busy / wall_us, gptq_kernels_ms=ours / 1e3,
               k8_ms=k8 / 1e3, blocks=res.blocks, tokens=res.ncommit,
               launches=sum(r[1] for r in rows))
    log(f"trace (hsd, {res.ncommit} tokens, {res.blocks} blocks, under the "
        f"profiler; K8 routes FLASH_DECODE={FD.FLASH_DECODE} "
        f"FUSED_ATTN={FD.FUSED_ATTN}): wall {out['wall_ms']:.1f} ms, device "
        f"busy {out['device_busy_ms']:.1f} ms (GPTQ kernels "
        f"{out['gptq_kernels_ms']:.1f} ms, K8 {out['k8_ms']:.1f} ms), idle "
        f"share {out['idle_share']:.3f}, {out['launches']} device ops")
    for dev_us, count, key in rows[:10]:
        log(f"  {dev_us / 1e3:9.3f} ms  x{count:<6} {key[:90]}")
    return out


def host_cost(draft, target):
    """Host microseconds to enqueue one K4 wrapper call at the draft step's
    shape, one K2 call (the 14B tail at 11 rows) and one small PyTorch op,
    with the device left to run behind. K2's device time exceeds its host
    time, so it is enqueued in bursts of 20 calls from an idle queue (140
    launches, well inside the launch queue) and the median burst counts."""
    w = draft.layers["wqkv"].layer(0)
    x = torch.randn((1, w.din), device=DEV).to(torch.bfloat16)
    big = target.big.layers
    tw = [big[k].layer(0) for k in ("wo", "wgu", "wdown")]
    att = torch.randn((11, tw[0].din), device=DEV).to(torch.bfloat16)
    res = torch.randn((11, tw[1].din), device=DEV).to(torch.bfloat16)
    ln = torch.ones(tw[1].din, device=DEV)
    out = {}
    for name, fn, calls, bursts in (
            ("k4_wrapper_us",
             lambda: G.int8_matmul(x, w.qweight, w.scales, w.zeros), 500, 1),
            ("k2_wrapper_us",
             lambda: G.attn_mlp_int4(att, res, *(t for q in tw for t in (
                 q.qweight, q.scales)), ln, 1e-6), 20, 15),
            ("torch_add_us", lambda: torch.add(x, x), 500, 1)):
        for _ in range(20):
            fn()
        per = []
        for _ in range(bursts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        out[name] = statistics.median(per)
    log(f"host cost per call: K4 wrapper {out['k4_wrapper_us']:.1f} us, "
        f"K2 wrapper {out['k2_wrapper_us']:.1f} us, "
        f"torch.add {out['torch_add_us']:.1f} us")
    return out


def main_path(draft, target, cfg_s, cfg_b, trace, launched=SPEC_KERNELS,
              absent=("K8",), max_new=MAX_NEW):
    """hsd and tokenwise (gamma 10, K 1) on N_PROMPTS prompts of BUCKET
    tokens, max_new new tokens each, on the coupled pair; every kernel of
    `launched` must launch over the two runs and none of `absent`; then AR
    over AR_NEW tokens. Returns (results, the runs' launch counts)."""
    fwd, ops = make_coupled_target(cfg_s, cfg_b)
    prompts = [((torch.arange(BUCKET, device=DEV) + 97 * i) % 1000) + 10
               for i in range(N_PROMPTS)]

    def gen_for(method, max_new=max_new, temperature=1.0):
        eng = EngineConfig(verifier=VerifierConfig(method=method, gamma=GAMMA,
                                                   num_drafts=1),
                           max_new_tokens=max_new, temperature=temperature)
        return make_generate(cfg_s, cfg_b, eng, target_forward=fwd,
                             target_cache_ops=ops)

    # warm the path (allocator, cuBLAS handles) outside the counted run
    gen_for("hsd", max_new=12)(draft, target, prompts[0], BUCKET,
                               torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    reset_launches()
    results = {}
    for mi, method in enumerate(("hsd", "tokenwise")):
        gen = gen_for(method)
        per_prompt, toks, secs = [], 0, 0.0
        for i, prompt in enumerate(prompts):
            gch = torch.Generator(device=DEV).manual_seed(100 * mi + i)
            t0 = time.perf_counter()
            res = gen(draft, target, prompt, BUCKET, gch)
            torch.cuda.synchronize()
            secs += time.perf_counter() - t0
            toks += res.ncommit
            acc = res.accepts[:res.blocks].float()
            per_prompt.append(float((acc + 1).mean()))
            out = res.tokens[BUCKET:res.length]
            if not (0 <= int(out.min()) and int(out.max()) < cfg_b.vocab_size):
                raise AssertionError(f"{method}: token out of range")
            if res.ncommit < 1:
                raise AssertionError(f"{method}: nothing committed")
        be = statistics.mean(per_prompt)
        results[method] = dict(be=be, tok_s=toks / secs, tokens=toks,
                               secs=secs, per_prompt=per_prompt)
        log(f"main path {method}: BE {be:.4f} (per prompt {per_prompt}) "
            f"{toks / secs:.2f} tok/s ({toks} tokens in {secs:.2f}s)")
    counts = launch_counts()
    log(f"launch counters over the hsd+tokenwise runs: {counts}")
    for k in launched:
        if counts[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    for k in absent:
        if counts[k]:
            raise AssertionError(f"{k} launched on the default path")

    ar = make_autoregressive(cfg_b, EngineConfig(max_new_tokens=AR_NEW),
                             model_forward=fwd, cache_init=ops[0])
    ar(target, prompts[0], BUCKET, torch.Generator(device=DEV).manual_seed(7))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, length = ar(target, prompts[0], BUCKET,
                   torch.Generator(device=DEV).manual_seed(8))
    torch.cuda.synchronize()
    ar_s = time.perf_counter() - t0
    results["ar_tok_s"] = (length - BUCKET) / ar_s
    log(f"AR: {length - BUCKET} tokens in {ar_s:.3f}s = "
        f"{results['ar_tok_s']:.2f} tok/s")
    if trace:
        # 56 new tokens: a cache of 132 slots, which K8's gates admit
        trace_window(gen_for("hsd", max_new=56), draft, target, prompts[1])
        with opted_in("FUSED_ATTN"):
            trace_window(gen_for("hsd", max_new=56), draft, target,
                         prompts[1])
        host_cost(draft, target)
    return results, counts


def greedy_prefix(cfg_s, cfg_b, draft, target, prompt, new, gamma, fwd=None,
                  ops=None):
    """Greedy speculative decoding and greedy AR over `new` tokens at full
    width (the target's own forward unless `fwd` / `ops` are given): the
    length of the streams' common prefix, reported only (a bf16 einsum
    may round by row count)."""
    eng0 = EngineConfig(verifier=VerifierConfig(method="greedy", gamma=gamma),
                        max_new_tokens=new, temperature=0.0)
    res = make_generate(cfg_s, cfg_b, eng0, target_forward=fwd,
                        target_cache_ops=ops)(draft, target, prompt,
                                              BUCKET, None)
    ar_toks, ar_len = make_autoregressive(
        cfg_b, eng0, model_forward=fwd,
        cache_init=None if ops is None else ops[0])(target, prompt, BUCKET,
                                                    None)
    a = res.tokens[BUCKET:res.length].tolist()
    b = ar_toks[BUCKET:ar_len].tolist()
    common = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                  min(len(a), len(b)))
    log(f"full-width greedy: spec and AR agree on the first {common} of "
        f"{min(len(a), len(b))} tokens")
    return common


def greedy_small():
    """2-layer float32 pair through the same kernels: spec == AR, asserted."""
    cfg_s = ModelConfig.tiny(vocab_size=512, hidden_size=256,
                             intermediate_size=512, num_heads=4,
                             num_kv_heads=2, dtype=torch.float32,
                             eos_token_id=10**9)
    small = fuse_params(cfg_s, init_params(cfg_s, seed=5, device=DEV))
    draft = quantize_draft(cfg_s, small, bits=8)
    target = init_quantized_params(cfg_s, seed=6, bits=4, device=DEV)
    eng = EngineConfig(verifier=VerifierConfig(method="greedy", gamma=4),
                       max_new_tokens=48, temperature=0.0)
    prompt = (torch.arange(16, device=DEV) % 300) + 3
    before = launch_counts()
    res = make_generate(cfg_s, cfg_s, eng)(draft, target, prompt, 12, None)
    toks, length = make_autoregressive(cfg_s, eng)(target, prompt, 12, None)
    used = {k: v - before[k] for k, v in launch_counts().items()}
    n = min(res.length, length)
    a, b = res.tokens[16:n].tolist(), toks[16:n].tolist()
    log(f"greedy 2-layer f32: {len(a)} tokens, spec == AR: {a == b}; "
        f"kernel launches {used}")
    if a != b or len(a) < 48:
        raise AssertionError(f"greedy spec != greedy AR:\n{a}\n{b}")
    if min(used[k] for k in SPEC_KERNELS) <= 0:
        raise AssertionError(f"greedy config missed a kernel: {used}")
    greedy_serving_small(cfg_s, draft, target)


def greedy_serving_small(cfg, draft, target):
    """Phase 6's pair at temperature 0: every SlotEngine request and every
    make_generate_batched row equals AR, at K 1 and K 2 striped; and UAD."""
    ar = make_autoregressive(cfg, EngineConfig(max_new_tokens=24,
                                               temperature=0.0))
    prompts = [[(7 * i + 13 * j) % 500 + 3 for j in range(6 + 2 * i)]
               for i in range(6)]
    budgets = [24, 5, 17, 24, 9, 12]
    bucket = 16

    def ar_stream(ids, n):
        padded = torch.tensor([0] * (bucket - len(ids)) + ids, device=DEV)
        toks, length = ar(target, padded, len(ids), None)
        return toks[bucket:length].tolist()[:n]

    want = [ar_stream(p, 24) for p in prompts]
    for K, parallel, method in ((1, True, "greedy"), (2, False, "hsd")):
        eng = EngineConfig(verifier=VerifierConfig(
            method=method, gamma=4, num_drafts=K, parallel=parallel),
            max_new_tokens=24, temperature=0.0)
        se = SlotEngine(cfg, cfg, eng, n_slots=4, bucket=bucket,
                        params_d=draft, params_t=target,
                        steps_per_dispatch=2, device=DEV)
        for rid, (p, mn) in enumerate(zip(prompts, budgets)):
            se.submit(rid, p, max_new=mn)
        done = {r.rid: r.out_tokens for r in se.run_all()}
        ok_srv = all(done[i] == want[i][:budgets[i]] for i in range(6))
        P = torch.stack([torch.tensor([0] * (bucket - len(p)) + p,
                                      device=DEV) for p in prompts[:4]])
        bres = make_generate_batched(cfg, cfg, eng)(
            draft, target, P, [len(p) for p in prompts[:4]], [None] * 4)
        ok_b = all(bres.tokens[i, bucket:int(bres.length[i])].tolist()
                   == want[i] for i in range(4))
        log(f"greedy 2-layer f32, {method} K {K} "
            f"{'parallel' if parallel else 'striped'}: every SlotEngine "
            f"request == AR: {ok_srv}; every make_generate_batched row == "
            f"AR: {ok_b}")
        if not (ok_srv and ok_b):
            raise AssertionError(f"greedy serving != AR ({method} K {K})")
    # UAD at temperature 0: one letter a token, the AR stream
    tok, drafter = uad_drafter()
    eng = EngineConfig(verifier=VerifierConfig(method="tokenwise", gamma=4),
                       max_new_tokens=24, temperature=0.0)
    ids = tok.encode("abcabdabcabd")
    out = make_uad_generate(cfg, eng, drafter, device=DEV)(target, ids, None)
    toks, length = ar(target, torch.tensor(ids, device=DEV), len(ids), None)
    ok = out == toks[len(ids):length].tolist()
    log(f"greedy 2-layer f32 UAD: {len(out)} tokens, == AR: {ok}")
    if not ok:
        raise AssertionError("greedy UAD != AR")


def eagle_kernel_phase(target, cfg):
    g = torch.Generator(device=DEV).manual_seed(321)
    big = target.big.layers
    D, eps = cfg.hidden_size, cfg.rms_norm_eps
    ln = torch.rand((4, D), generator=g, device=DEV) + 0.5
    rows = EAGLE_SLOTS * 60           # the pool forward: 8 slots x 60 nodes

    def act(n, d):
        return torch.randn((n, d), generator=g, device=DEV).to(torch.bfloat16)

    # a row's bits do not depend on how many rows share its launch: K5
    # (wqkv) and K4 (wdown) at 1, 17, 64 and 128 rows, in bf16 and in f32;
    # K7 at 129, 480 and 1024 rows
    x = act(G.BF16_MAX_ROWS, D)
    w = big["wqkv"].layer(0)
    wd = big["wdown"].layer(0)
    xd = act(128, wd.din)
    for dt in (torch.bfloat16, torch.float32):
        x5, x4 = x[:128].to(dt), xd.to(dt)
        k5 = G.int8_ln_matmul(x5, w.qweight, w.scales, ln[0], eps)
        k4 = G.int8_matmul(x4, wd.qweight, wd.scales)
        for n in (1, 17, 64):
            if not (torch.equal(G.int8_ln_matmul(x5[:n], w.qweight, w.scales,
                                                 ln[0], eps), k5[:n])
                    and torch.equal(G.int8_matmul(x4[:n], wd.qweight,
                                                  wd.scales), k4[:n])):
                raise AssertionError(f"K4 or K5 rows differ between {n} and "
                                     f"128 rows ({dt})")
    k7 = G.int8_matmul_bf16(x, w.qweight, w.scales, ln=ln[0], eps=eps)
    for n in (G.BF16_MIN_ROWS, rows):
        if not torch.equal(G.int8_matmul_bf16(x[:n], w.qweight, w.scales,
                                              ln=ln[0], eps=eps), k7[:n]):
            raise AssertionError(f"K7 rows differ between {n} and "
                                 f"{len(x)} rows")
    log("eagle kernels: K5 (wqkv) and K4 (wdown) give the same bits for a "
        "row at 1, 17, 64 and 128 rows, in bf16 and in f32; K7 at "
        f"{G.BF16_MIN_ROWS}, {rows} and {len(x)} rows")

    # K7's pre-pass against its plain version: the inverse RMS within
    # 2^-21 (another summation order), the normed rows bf16((x * inv) * ln)
    # bit for bit from the kernel's own inv and within one bf16 step of
    # the plain rows
    for n in (G.BF16_MIN_ROWS, rows, len(x)):
        inv, xn = G.k7_stage(x[:n], ln[0], eps)
        pinv, pxn = G.k7_stage_plain(x[:n], ln[0], eps)
        torch.cuda.synchronize()
        inv_err = ((inv - pinv).abs() / pinv).max().item()
        exact = torch.equal(xn, ((x[:n].float() * inv[:, None]) * ln[0])
                            .to(torch.bfloat16))
        step = 2.0 ** (torch.floor(torch.log2(pxn.float().abs())) - 7)
        diff = (xn.float() - pxn.float()).abs()
        flips = int((diff > 0).sum().item())
        if not (inv_err <= 2.0 ** -21 and exact
                and bool((diff <= step).all())):
            raise AssertionError(f"K7 pre-pass at {n} rows: inv rel error "
                                 f"{inv_err}, xn exact from its inv {exact}, "
                                 f"{flips} values off the plain version's")
        log(f"eagle kernels: K7 pre-pass at {n} rows: inv rel error "
            f"{inv_err:.2e} (tol {2.0 ** -21:.2e}), xn == bf16((x * inv) * "
            f"ln) from its own inv, {flips} of {xn.numel()} values one bf16 "
            "step from the plain version's")

    def case(name, label, w: QuantizedLinear, n, norm):
        quant_case(name, label, w, n, act, ln if norm else None, eps)

    log("eagle kernels: K5 (int8, fused RMSNorm)")
    case("K5", "wqkv 4096x6144", big["wqkv"], 1, True)
    case("K5", "wqkv 4096x6144", big["wqkv"], 60, True)
    case("K5", "wgu 4096x28672", big["wgu"], 60, True)
    log("eagle kernels: K7 (bf16 tensor-core operands)")
    for n in (129, rows):
        case("K7", "wqkv 4096x6144 +norm", big["wqkv"], n, True)
        case("K7", "wgu 4096x28672 +norm", big["wgu"], n, True)
    case("K7", "wo 4096x4096", big["wo"], rows, False)
    case("K7", "wdown 14336x4096", big["wdown"], rows, False)
    case("K7", "lm_head 4096x128256", target.big.lm_head, rows, False)
    for r in KERNEL_ROWS:
        if r["name"] == "K7":
            log(f"K7 {r['label']:<28} n={r['n']:<3} {r['flops'] / r['ms'] / 1e9:.1f}"
                f" TFLOP/s, {r['bound_ms'] / r['ms']:.3f} of the bound "
                f"({r['bound_by']})")
    log("eagle kernels: K4 (symmetric int8) at the prefill's shapes")
    case("K4", "wo 4096x4096", big["wo"], EAGLE_BUCKET, False)
    case("K4", "wdown 14336x4096", big["wdown"], EAGLE_BUCKET, False)
    for n in (1, EAGLE_BUCKET):
        case("K4", "lm_head 4096x128256", target.big.lm_head, n, False)


def prefill_last_only(target, cfg, fwd):
    """One bucket-long prefill of the coupled target with the head and the
    oracle on the last position (what the engine runs) against one with
    every position's logits: the last rows agree; both timed."""
    from hsd_tpu_torch.engine.kvcache import init_cache
    prompt = torch.arange(EAGLE_BUCKET, device=DEV)[None] % 900 + 10
    pos = torch.arange(EAGLE_BUCKET, device=DEV)[None]
    out, ms = {}, {}
    for last in (False, True):
        times = []
        for _ in range(3):
            cache = init_cache(cfg, 1, EAGLE_BUCKET, DEV)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _, _ = fwd(target, prompt, cache, None, pos,
                               last_only=last)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[last], ms[last] = logits[:, -1], statistics.median(times)
    diff = (out[True] - out[False]).abs().max().item()
    log(f"eagle prefill ({EAGLE_BUCKET} tokens): last position only "
        f"{ms[True]:.2f} ms, every position {ms[False]:.2f} ms; last rows "
        f"differ by {diff:.3e}")
    if not diff <= TOL * out[False].abs().max().item():
        raise AssertionError(f"last-only prefill logits differ by {diff}")
    return dict(last_only_ms=ms[True], full_ms=ms[False], max_diff=diff)


def eagle_serving(target, head, cfg, ecfg, trace,
                  launched=("K4", "K5", "K7"), absent=("K8",),
                  label="eagle"):
    """The EAGLE serving path at full width: every request's stream in
    range and within budget; the `launched` kernels launched and the
    `absent` ones not; a repeat run identical."""
    fwd = make_coupled_eagle_target(cfg, (-1,))
    prefill = prefill_last_only(target, cfg, fwd)
    warm, prompts = BM.eagle_serving_requests(EAGLE_REQS, EAGLE_BUCKET)

    def engine(mode, steps=EAGLE_MACRO):
        return EagleSlotEngine(
            cfg, ecfg, EngineConfig(max_new_tokens=EAGLE_NEW, temperature=1.0),
            n_slots=EAGLE_SLOTS, bucket=EAGLE_BUCKET, params_t=target,
            params_e=head, mode=mode, seed=1, target_forward=fwd,
            steps_per_dispatch=steps, admit_batch=EAGLE_SLOTS)

    def serve(mode):
        se = engine(mode)
        se.submit(10_000, warm, max_new=4)
        se.run_all()                                   # warm every path
        torch.cuda.synchronize()
        reset_launches()
        for rid, p in enumerate(prompts):
            se.submit(rid, p, max_new=EAGLE_NEW)
        t0 = time.perf_counter()
        done = se.run_all()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        if sorted(r.rid for r in done) != list(range(EAGLE_REQS)):
            raise AssertionError(f"{mode}: requests lost")
        for r in done:
            if not 1 <= len(r.out_tokens) <= EAGLE_NEW or not all(
                    0 <= t < cfg.vocab_size for t in r.out_tokens):
                raise AssertionError(f"{mode}: bad stream for {r.rid}")
        toks = sum(len(r.out_tokens) for r in done)
        blocks = sum(r.blocks for r in done)
        be = (sum(r.accepts for r in done) + blocks) / blocks
        streams = {r.rid: r.out_tokens for r in done}
        digest = hashlib.sha256(json.dumps(
            streams, sort_keys=True).encode()).hexdigest()[:16]
        out = dict(mode=mode, tok_s=toks / secs, be=be, tokens=toks,
                   blocks=blocks, secs=secs, launches=counts,
                   streams=streams, sha256=digest)
        log(f"{label} serving {mode}: {toks} tokens in {secs:.2f}s = "
            f"{toks / secs:.2f} tok/s, BE {be:.4f} over {blocks} slot-blocks; "
            f"streams sha256 {digest}; launches {counts}")
        for k in launched:
            if counts[k] <= 0:
                raise AssertionError(f"{mode}: {k} was not launched")
        for k in absent:
            if counts[k]:
                raise AssertionError(f"{mode}: {k} launched {counts[k]} "
                                     "times on this path")
        return out

    results = {mode: serve(mode) for mode in ("hsd_ref", "hsd")}
    again = serve("hsd_ref")
    if again["streams"] != results["hsd_ref"]["streams"]:
        raise AssertionError("hsd_ref streams differ between two runs")
    log(f"{label} serving: a repeat hsd_ref run gives identical streams "
        f"(sha256 {again['sha256']}, {again['tok_s']:.2f} tok/s)")
    results["repeat_tok_s"] = again["tok_s"]
    results["prefill"] = prefill
    if trace:
        trace_pool(engine("hsd_ref", steps=1), prompts)
    return results


def trace_pool(se, prompts):
    """Device time by kernel and idle share of one pool step (8 slots, no
    admission inside the window), under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    for rid, p in enumerate(prompts[:EAGLE_SLOTS]):
        se.submit(rid, p, max_new=EAGLE_NEW)
    se.step()                             # admission + one block, untraced
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        se.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    mma = sum(r[0] for r in rows if "mma_kernel" in r[2])
    log(f"trace (one pool step, {EAGLE_SLOTS} slots, under the profiler): "
        f"wall {wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms (K7 "
        f"{mma / 1e3:.1f} ms), idle share {1 - busy / wall_us:.3f}, "
        f"{sum(r[1] for r in rows)} device ops")
    for dev_us, count, key in rows[:12]:
        log(f"  {dev_us / 1e3:9.3f} ms  x{count:<6} {key[:90]}")
    phase_times(se)


def phase_times(se):
    """Host-clock milliseconds of each phase of one pool step, run one
    phase at a time (a synchronize before and after each), so the sum
    exceeds the overlapped step: trie drafting, the target tree forward,
    trie verification, the staged KV compaction, and the rest (commit,
    sampling, the server's bookkeeping)."""
    import hsd_tpu_torch.engine.eagle_engine as EE
    spent = {}

    def timed_phase(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return run

    saved = {n: getattr(EE, n) for n in ("build_trie", "verify_trie_hsd",
                                          "compact_path_staged")}
    pool = se._pool_block
    try:
        for n, f in saved.items():
            setattr(EE, n, timed_phase(n, f))
        se._pool_block = EE.make_eagle_pool(
            se.cfg_t, se.ecfg, se.engine, mode="hsd_ref",
            target_forward=timed_phase("target_forward",
                                       make_coupled_eagle_target(
                                           se.cfg_t, (-1,))))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        se.step()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for n, f in saved.items():
            setattr(EE, n, f)
        se._pool_block = pool
    spent["rest"] = total - sum(spent.values())
    log(f"phases of one pool step, serialized ({total:.1f} ms): " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in spent.items()))


def eagle_greedy_small():
    """2-layer float32 Llama-shaped pair, symmetric-int8 target: greedy
    EAGLE (single request and every server request) == AR, through K5."""
    cfg = ModelConfig.tiny(vocab_size=512, hidden_size=256,
                           intermediate_size=512, num_heads=4,
                           num_kv_heads=2, dtype=torch.float32,
                           attention_bias=False, tie_word_embeddings=False,
                           eos_token_id=10**9)
    ecfg = EagleConfig(hidden_size=256, target_hidden_size=256, num_heads=4,
                       num_kv_heads=2, vocab_size=512, draft_vocab_size=384,
                       intermediate_size=512, rope_theta=cfg.rope_theta,
                       top_k=4, depth=3, total_tokens=11,
                       dtype=torch.float32, version=1)
    head, target = build_coupled_eagle_pair(5, cfg, ecfg, scale=4.0, lam=1.0,
                                            big_bits=8, device=DEV)
    fwd = make_coupled_eagle_target(cfg, (-1,))
    eng = EngineConfig(max_new_tokens=32, temperature=0.0)
    ar = make_autoregressive(
        cfg, eng, model_forward=lambda p, t, c, skip_head=False:
        fwd(p, t, c, None, None)[:2])

    def ar_stream(prompt, plen):
        toks, length = ar(target, prompt, plen, None)
        return toks[prompt.shape[0]:length].tolist()

    before = launch_counts()
    prompt = (torch.arange(16, device=DEV) % 300) + 3
    res = make_eagle_generate(cfg, ecfg, eng, mode="greedy",
                              target_forward=fwd)(target, head, prompt, 12,
                                                  None)
    a, b = res.tokens[16:res.length].tolist(), ar_stream(prompt, 12)
    log(f"eagle greedy 2-layer f32: {len(a)} tokens in {res.blocks} blocks, "
        f"EAGLE == AR: {a == b}")
    if a != b or len(a) < 32:
        raise AssertionError(f"greedy EAGLE != greedy AR:\n{a}\n{b}")
    se = EagleSlotEngine(cfg, ecfg, eng, n_slots=2, bucket=16,
                         params_t=target, params_e=head, mode="greedy",
                         target_forward=fwd, steps_per_dispatch=2)
    reqs = [list(range(3 + 7 * i, 14 + 7 * i)) for i in range(3)]
    for rid, p in enumerate(reqs):
        se.submit(rid, p, max_new=32)
    for r in se.run_all():
        padded = torch.tensor([0] * (16 - len(reqs[r.rid])) + reqs[r.rid],
                              device=DEV)
        if r.out_tokens != ar_stream(padded, len(reqs[r.rid])):
            raise AssertionError(f"server request {r.rid} != AR")
    used = {k: v - before[k] for k, v in launch_counts().items()}
    log(f"eagle greedy: every server request == AR; launches {used}")
    if used["K5"] <= 0:
        raise AssertionError("the greedy EAGLE pair did not launch K5")


def int4_eagle_kernel_phase(target, cfg):
    """Phase 11: K7i4 at the int4 pool forward's shapes (129 and 480 rows)
    in both forms, K1/K3 at the prefill's, each against its plain version
    and timed; a row's bits row-count-free; asymmetric weights through the
    bf16 route; which of K7 and K7i4 launches where."""
    g = torch.Generator(device=DEV).manual_seed(654)
    big = target.big.layers
    D, eps = cfg.hidden_size, cfg.rms_norm_eps
    ln = torch.rand((4, D), generator=g, device=DEV) + 0.5
    rows = EAGLE_SLOTS * 60           # the pool forward: 8 slots x 60 nodes

    def act(n, d):
        return torch.randn((n, d), generator=g, device=DEV).to(torch.bfloat16)

    reset_launches()
    # a row's bits do not depend on how many rows share its launch
    x = act(rows, D)
    w = big["wqkv"].layer(0)
    wo = big["wo"].layer(0)
    for norm in ({"ln": ln[0], "eps": eps}, {}):
        full = G.int4_matmul_bf16(x, (w if norm else wo).qweight,
                                  (w if norm else wo).scales, **norm)
        part = G.int4_matmul_bf16(x[:129], (w if norm else wo).qweight,
                                  (w if norm else wo).scales, **norm)
        if not torch.equal(part, full[:129]):
            raise AssertionError("K7i4 rows differ between 129 and "
                                 f"{rows} rows (norm: {bool(norm)})")
    log(f"int4 eagle kernels: K7i4 gives the same bits for a row at 129 and "
        f"{rows} rows, with and without the norm")

    # K7i4's pre-pass against its plain version: phase 8's checks of the
    # inverse RMS and the normed rows, and the group sums of the unrounded
    # normed rows, which the correction takes, within 1e-6 of their
    # absolute sums of the same sums on the kernel's own inv (summation
    # order) and within 1e-5 of the plain version's (its inv)
    groups = w.scales.shape[-2]
    for n in (G.BF16_MIN_ROWS, rows):
        inv, xn, xg = G.k7_stage(x[:n], ln[0], eps, groups=groups)
        pinv, pxn, pxg = G.k7_stage_plain(x[:n], ln[0], eps, groups=groups)
        torch.cuda.synchronize()
        inv_err = ((inv - pinv).abs() / pinv).max().item()
        xs = (x[:n].float() * inv[:, None]) * ln[0]
        exact = torch.equal(xn, xs.to(torch.bfloat16))
        grouped = xs.reshape(n, groups, -1)
        mag = grouped.abs().sum(-1)
        own_err = ((xg - grouped.sum(-1)).abs() / mag).max().item()
        plain_err = ((xg - pxg).abs() / mag).max().item()
        if not (inv_err <= 2.0 ** -21 and exact and own_err <= 1e-6
                and plain_err <= 1e-5):
            raise AssertionError(f"K7i4 pre-pass at {n} rows: inv rel error "
                                 f"{inv_err}, xn exact from its inv {exact}, "
                                 f"xg rel error {own_err} (own inv), "
                                 f"{plain_err} (plain)")
        log(f"int4 eagle kernels: K7i4 pre-pass at {n} rows: inv rel error "
            f"{inv_err:.2e} (tol {2.0 ** -21:.2e}), xn == bf16((x * inv) * "
            f"ln) from its own inv, xg rel error {own_err:.2e} on its inv "
            f"(tol 1e-6), {plain_err:.2e} against the plain version's (tol "
            "1e-5)")

    def case(name, label, w: QuantizedLinear, n, norm):
        quant_case(name, label, w, n, act, ln if norm else None, eps)

    log("int4 eagle kernels: K7i4 (bf16 tensor-core operands, packed int4)")
    for n in (129, rows):
        case("K7i4", "wqkv 4096x6144 +norm", big["wqkv"], n, True)
        case("K7i4", "wgu 4096x28672 +norm", big["wgu"], n, True)
        case("K7i4", "wo 4096x4096", big["wo"], n, False)
        case("K7i4", "wdown 14336x4096", big["wdown"], n, False)
        case("K7i4", "lm_head 4096x128256", target.big.lm_head, n, False)
    for r in KERNEL_ROWS:
        if r["name"] == "K7i4":
            log(f"K7i4 {r['label']:<28} n={r['n']:<3} "
                f"{r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s, "
                f"{r['bound_ms'] / r['ms']:.3f} of the bound ({r['bound_by']})")
    log("int4 eagle kernels: K1 and K3 at the prefill's shapes")
    case("K1", "wqkv 4096x6144 +norm", big["wqkv"], EAGLE_BUCKET, True)
    case("K1", "wgu 4096x28672 +norm", big["wgu"], EAGLE_BUCKET, True)
    case("K3", "wo 4096x4096", big["wo"], EAGLE_BUCKET, False)
    case("K3", "wdown 14336x4096", big["wdown"], EAGLE_BUCKET, False)
    case("K3", "lm_head 4096x128256", target.big.lm_head, 1, False)
    counts = launch_counts()
    if counts["K7"]:
        raise AssertionError(f"K7 (int8) launched over the int4 cases: "
                             f"{counts}")

    # asymmetric weights through the bf16 route: the norm first, rounded,
    # then K7i4 / K7 with the zero-point correction
    dense = (torch.randn((D, D), generator=g, device=DEV)
             * D ** -0.5).to(torch.bfloat16)
    x = act(rows, D)
    lnw = ln[1]
    for bits, key, plain in ((4, "K7i4", G.int4_matmul_plain),
                             (8, "K7", G.int8_matmul_plain)):
        qw = quantize(dense, bits=bits, group_size=128)
        before = launch_counts()[key]
        got = apply_linear(qw, x, norm=(lnw, eps), mxu_bf16=True)
        if launch_counts()[key] != before + 1:
            raise AssertionError(f"asymmetric int{bits}: {key} not launched")
        want = plain(rms_norm(x, lnw, eps), qw.qweight, qw.scales, qw.zeros,
                     bf16_operands=True)
        err = (got.float() - want.float()).abs().max().item()
        if not err <= TOL * want.float().abs().max().item():
            raise AssertionError(f"asymmetric int{bits} through the bf16 "
                                 f"route: error {err}")
        log(f"int4 eagle kernels: asymmetric int{bits} {D}x{D} through the "
            f"bf16 route ({key}), {rows} rows: error {err:.3e}")
    # at 128 rows the bf16 operands do not apply: K1 / K3, never K7i4
    before = launch_counts()
    x = act(128, D)
    apply_linear(w, x, norm=(ln[0], eps), mxu_bf16=True)
    apply_linear(wo, x, mxu_bf16=True)
    after = launch_counts()
    used = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    if used != {"K1": 1, "K3": 1}:
        raise AssertionError(f"128 rows with mxu_bf16: launches {used}")
    log(f"int4 eagle kernels: at 128 rows apply_linear launches {used}; "
        f"K7 (int8) launched {after['K7']} times over phase 11, for the "
        "asymmetric int8 weight only")
    if after["K7"] != 1:
        raise AssertionError(f"K7 launches over phase 11: {after['K7']}")
    # at 129 rows without mxu_bf16: the dequantize-then-dot route, no kernel
    route_a_case("wqkv 4096x6144 +norm", big["wqkv"], (129,), act, ln, eps)
    route_a_case("wgu 4096x28672 +norm", big["wgu"], (129,), act, ln, eps)
    route_a_case("lm_head 4096x128256", target.big.lm_head, (129,), act,
                 None, eps)


EAGLE3_CONFIG = {   # yuhuili/EAGLE3-LLaMA3.1-Instruct-8B, config.json
    "architectures": ["LlamaForCausalLMEagle3"], "hidden_size": 4096,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "intermediate_size": 14336, "vocab_size": 128256,
    "draft_vocab_size": 32000, "rms_norm_eps": 1e-05,
    "rope_theta": 500000.0, "num_hidden_layers": 1}
V3_REQS, V3_NEW = 8, 32


def eagle3_phase(trunk, cfg):
    """Phase 13: the EAGLE-3 head at full width over the int4 trunk, run as
    a plain target with its three feature taps: K4 at the head's shapes
    against its plain version, then a warm request and 8 served. The head
    is random, so the trie is rarely accepted: BE near 1, no bar."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/config.json"
        with open(path, "w") as f:
            json.dump(EAGLE3_CONFIG, f)
        ecfg = EagleConfig.from_json(path, top_k=10, depth=6,
                                     total_tokens=59)
    head = quantize_eagle_params(init_eagle_params(ecfg, seed=3, device=DEV),
                                 bits=8)
    torch.cuda.synchronize()
    log(f"eagle-3 head: {ecfg.hidden_size} wide, fc {tuple(head.fc.qweight.shape)}, "
        f"draft vocab {ecfg.draft_vocab_size}, int8 (groups of "
        f"{head.wq.din // head.wq.scales.shape[0]}); "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    # K4 at the head's shapes against its plain version: fc at 1 row and at
    # the absorb window's 8 slots x 8 pairs, the rest at 1 row and at the
    # beam's 8 slots x top_k
    g = torch.Generator(device=DEV).manual_seed(987)

    def act(n, d):
        return torch.randn((n, d), generator=g, device=DEV).to(torch.bfloat16)

    window = EAGLE_SLOTS * (ecfg.depth + 2)
    for name, rows in (("fc", window), ("wq", EAGLE_SLOTS * ecfg.top_k),
                       ("wgate", EAGLE_SLOTS * ecfg.top_k),
                       ("wdown", EAGLE_SLOTS * ecfg.top_k),
                       ("lm_head", EAGLE_SLOTS * ecfg.top_k)):
        w = getattr(head, name)
        for n in (1, rows):
            quant_case("K4", f"head {name} {w.din}x{w.qweight.shape[-1]}", w,
                       n, act, None, ecfg.rms_norm_eps)
    rng = np.random.default_rng(3)
    warm = rng.integers(10, 1000, (EAGLE_BUCKET,)).tolist()
    prompts = [rng.integers(10, 1000, (int(rng.integers(32, 64)),)).tolist()
               for _ in range(V3_REQS)]
    se = EagleSlotEngine(cfg, ecfg, EngineConfig(max_new_tokens=V3_NEW,
                                                 temperature=1.0),
                         n_slots=EAGLE_SLOTS, bucket=EAGLE_BUCKET,
                         params_t=trunk, params_e=head, mode="hsd", seed=1,
                         steps_per_dispatch=EAGLE_MACRO,
                         admit_batch=EAGLE_SLOTS)
    se.submit(10_000, warm, max_new=4)
    se.run_all()                                       # warm every path
    torch.cuda.synchronize()
    reset_launches()
    for rid, p in enumerate(prompts):
        se.submit(rid, p, max_new=V3_NEW)
    t0 = time.perf_counter()
    done = se.run_all()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    if sorted(r.rid for r in done) != list(range(V3_REQS)):
        raise AssertionError("eagle-3 serving: requests lost")
    for r in done:
        if not 1 <= len(r.out_tokens) <= V3_NEW or not all(
                0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"eagle-3 serving: bad stream for {r.rid}")
    if se.state["feat_buf"].shape[-1] != 3 * cfg.hidden_size:
        raise AssertionError("eagle-3 serving: the feature buffer is not "
                             "3 x the target width")
    toks = sum(len(r.out_tokens) for r in done)
    blocks = sum(r.blocks for r in done)
    be = (sum(r.accepts for r in done) + blocks) / blocks
    log(f"eagle-3 serving hsd ({V3_REQS} requests, {V3_NEW} new tokens, "
        f"after a warm request): {toks} tokens in {secs:.2f}s = "
        f"{toks / secs:.2f} tok/s, BE {be:.4f} over {blocks} slot-blocks "
        f"(a random head: near 1 expected); launches {counts}")
    for k in ("K4", "K7i4"):
        if counts[k] <= 0:
            raise AssertionError(f"eagle-3 serving: {k} was not launched")
    out = dict(be=be, tok_s=toks / secs, launches=counts)

    tree = build_tree_buffers(mc_sim_7b_63)
    ecfg_t = eagle_config_for_tree(ecfg, tree)
    prompt = torch.tensor(prompts[0], device=DEV)
    prompt = torch.cat([torch.zeros(EAGLE_BUCKET - len(prompts[0]),
                                    dtype=prompt.dtype, device=DEV), prompt])
    t0 = time.perf_counter()
    res = make_eagle_generate(cfg, ecfg_t, EngineConfig(
        max_new_tokens=V3_NEW, temperature=1.0), mode="hsd",
        static_tree=tree)(trunk, head, prompt, len(prompts[0]),
                          torch.Generator(device=DEV).manual_seed(4))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = res.tokens[EAGLE_BUCKET:res.length].tolist()
    if not got or not all(0 <= t < cfg.vocab_size for t in got):
        raise AssertionError("eagle-3 static tree: bad stream")
    log(f"eagle-3 static tree mc_sim_7b_63 ({tree.num_nodes} nodes, depth "
        f"{tree.depth}): {res.ncommit} tokens in {res.blocks} blocks "
        f"({secs:.2f}s)")
    best, stats = autotune_total_tokens(
        cfg, ecfg, EngineConfig(max_new_tokens=16, temperature=1.0), trunk,
        head, prompt, len(prompts[0]), seed=5)
    log("eagle-3 autotune_total_tokens: " + ", ".join(
        f"{tt} nodes {tps:.2f} tok/s" for tt, tps in stats.items())
        + f"; picks {best.total_tokens}")
    out["autotune"] = stats
    return out


def eagle_greedy_v3_small():
    """Phase 14: 2-layer float32 pairs with a packed-int4 trunk and a
    random int8 v3 head: greedy v3 EAGLE, static-tree EAGLE and every
    EagleSlotEngine request equal AR (bf16 operands off: at more than 128
    rows they cannot equal a 1-row f32 AR)."""
    cfg = ModelConfig.tiny(vocab_size=512, hidden_size=256,
                           intermediate_size=512, num_heads=4,
                           num_kv_heads=2, dtype=torch.float32,
                           attention_bias=False, tie_word_embeddings=False,
                           eos_token_id=10**9)
    target = init_quantized_params(cfg, seed=6, bits=4, device=DEV)
    ecfg = EagleConfig(hidden_size=256, target_hidden_size=256, num_heads=4,
                       num_kv_heads=2, vocab_size=512, draft_vocab_size=384,
                       intermediate_size=512, rope_theta=cfg.rope_theta,
                       top_k=4, depth=3, total_tokens=11,
                       dtype=torch.float32, version=3)
    head = quantize_eagle_params(init_eagle_params(ecfg, seed=7, device=DEV))
    eng = EngineConfig(max_new_tokens=32, temperature=0.0)
    ar = make_autoregressive(cfg, eng)

    def ar_stream(prompt, plen):
        toks, length = ar(target, prompt, plen, None)
        return toks[prompt.shape[0]:length].tolist()

    before = launch_counts()
    prompt = (torch.arange(16, device=DEV) % 300) + 3
    tree = build_tree_buffers(mc_sim_7b_63)
    for name, e, kw in (("v3", ecfg, {}),
                        ("static tree", eagle_config_for_tree(ecfg, tree),
                         {"static_tree": tree})):
        res = make_eagle_generate(cfg, e, eng, mode="greedy", **kw)(
            target, head, prompt, 12, None)
        a, b = res.tokens[16:res.length].tolist(), ar_stream(prompt, 12)
        log(f"greedy {name} EAGLE 2-layer f32 int4: {len(a)} tokens in "
            f"{res.blocks} blocks, == AR: {a == b}")
        if a != b or len(a) < 32:
            raise AssertionError(f"greedy {name} EAGLE != AR:\n{a}\n{b}")
    se = EagleSlotEngine(cfg, ecfg, eng, n_slots=2, bucket=16,
                         params_t=target, params_e=head, mode="greedy",
                         steps_per_dispatch=2)
    reqs = [list(range(3 + 7 * i, 14 + 7 * i)) for i in range(3)]
    for rid, p in enumerate(reqs):
        se.submit(rid, p, max_new=32)
    for r in se.run_all():
        padded = torch.tensor([0] * (16 - len(reqs[r.rid])) + reqs[r.rid],
                              device=DEV)
        if r.out_tokens != ar_stream(padded, len(reqs[r.rid])):
            raise AssertionError(f"v3 server request {r.rid} != AR")
    used = {k: v - before[k] for k, v in launch_counts().items()}
    log(f"greedy v3: every EagleSlotEngine request == AR; launches {used}")
    if used["K4"] <= 0 or used["K1"] <= 0:
        raise AssertionError(f"greedy v3 missed a kernel: {used}")


def param_bytes(obj):
    """Device bytes of every tensor in a parameter structure."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(param_bytes(v) for v in obj.values())
    if isinstance(obj, tuple):
        return sum(param_bytes(v) for v in obj)
    return 0


def moe_row_bits(cfg, lp, rows, dtype, seed):
    """A row's router logits, top-k, weights and `_moe_ffn` output are the
    same bits at every row count of `rows` (asserted against the largest)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    n_max = max(rows)
    h = torch.randn((n_max, cfg.hidden_size), generator=g,
                    device=DEV).to(dtype)
    full = transformer.moe_route(cfg, lp["gate"], h)
    out = transformer._moe_ffn(cfg, lp, h[None])[0]
    for n in rows:
        part = transformer.moe_route(cfg, lp["gate"], h[-n:])
        got = transformer._moe_ffn(cfg, lp, h[None, -n:])[0]
        same = (all(torch.equal(a, b[-n:]) for a, b in zip(part, full))
                and torch.equal(got, out[-n:]))
        if not same:
            raise AssertionError(f"MoE row bits at {n} rows differ from "
                                 f"{n_max}")
    log(f"a row's router logits, top-k and _moe_ffn output are the same "
        f"bits at {', '.join(map(str, rows))} rows")


def launches_around(fn):
    """(fn's result, the kernel launches it made)."""
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in launch_counts().items()}


def expect_launches(label, used, want):
    """`used` must be exactly `want` (kernel -> count), every other kernel
    zero."""
    bad = {k: v for k, v in used.items() if v != want.get(k, 0)}
    log(f"{label}: launches {used}")
    if bad:
        raise AssertionError(f"{label}: launches {bad}, want {want}")


def mixtral_phase(trace):
    """Phase 15: Mixtral-8x7B at full width (32 layers, 8 experts, top-2)
    as the packed-int4 trunk of phase 5's coupled pair; K3 at the expert
    shapes; hsd / tokenwise / AR (with trace, a profiled hsd window); one
    verify's launches, wall and device time; a row's MoE bits across row
    counts; greedy spec vs AR on the target alone."""
    cfg_s = ModelConfig.qwen2_05b(vocab_size=32000, eos_token_id=2)
    cfg_m = ModelConfig.mixtral_8x7b()
    t0 = time.time()
    draft, target = build_coupled_pair(0, cfg_s, cfg_m, lam=0.0,
                                       logit_scale=LOGIT_SCALE, device=DEV)
    torch.cuda.synchronize()
    big = target.big
    out = dict(trunk_gib=param_bytes(big) / 2**30,
               alloc_gib=torch.cuda.memory_allocated() / 2**30)
    log(f"mixtral pair built in {time.time() - t0:.1f}s: the Mixtral-8x7B "
        f"int4 trunk {out['trunk_gib']:.2f} GiB, {out['alloc_gib']:.2f} GiB "
        f"allocated")
    g = torch.Generator(device=DEV).manual_seed(151)
    act = lambda n, d: torch.randn((n, d), generator=g, device=DEV).to(
        torch.bfloat16)
    for name, label in (("wgate", "mixtral expert w1 4096x14336"),
                        ("wdown", "mixtral expert w2 14336x4096")):
        quant_case("K3", label, big.layers[name].layer(0), MIXTRAL_VERIFY,
                   act, None, 0.0)

    out["results"], out["counts"] = main_path(
        draft, target, cfg_s, cfg_m, False, launched=("K1", "K3", "K4"),
        absent=("K2", "K6", "K7", "K7i4", "K8"), max_new=MIXTRAL_NEW)
    if trace:
        fwd, ops = make_coupled_target(cfg_s, cfg_m)
        eng = EngineConfig(verifier=VerifierConfig(method="hsd", gamma=GAMMA),
                           max_new_tokens=MIXTRAL_NEW)
        out["trace"] = trace_window(
            make_generate(cfg_s, cfg_m, eng, target_forward=fwd,
                          target_cache_ops=ops), draft, target,
            ((torch.arange(BUCKET, device=DEV) + 97) % 1000) + 10)

    # one 11-row target verify after a 64-row prefill: its launches, its
    # wall time, and under the profiler its device time by kernel
    toks = ((torch.arange(BUCKET + MIXTRAL_VERIFY, device=DEV) * 7) % 1000
            + 10)[None]
    cache = init_cache(cfg_m, 1, 2 * BUCKET, DEV)
    transformer.forward(cfg_m, big, toks[:, :BUCKET], cache, skip_head=True)
    verify = lambda: transformer.forward(
        cfg_m, big, toks[:, BUCKET:], cache.replace(length=BUCKET))[0]
    logits, used = launches_around(verify)
    if not (logits.shape == (1, MIXTRAL_VERIFY, cfg_m.vocab_size)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError("mixtral verify: logits not finite")
    L, E = cfg_m.num_layers, cfg_m.num_experts
    expect_launches(f"one {MIXTRAL_VERIFY}-row Mixtral verify", used,
                    {"K1": L, "K3": L * (1 + 3 * E) + 1})
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        verify()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        verify()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t1) * 1e3
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    out["verify"] = dict(wall_ms=statistics.median(walls),
                         wall_ms_all=walls, profiled_wall_ms=prof_wall,
                         device_ms=busy, idle_share=1 - busy / prof_wall,
                         device_ops=sum(r[1] for r in rows))
    log(f"one {MIXTRAL_VERIFY}-row Mixtral verify: wall "
        f"{out['verify']['wall_ms']:.2f} ms (median of 5: {walls}); under "
        f"the profiler wall {prof_wall:.2f} ms, device busy {busy:.3f} ms, "
        f"idle {out['verify']['idle_share']:.3f}, "
        f"{out['verify']['device_ops']} device ops")
    for dev_us, count, key in rows[:8]:
        log(f"  {dev_us / 1e3:9.3f} ms  x{count:<6} {key[:90]}")

    moe_row_bits(cfg_m, transformer.moe_params(big.layers, 0), MIXTRAL_ROWS,
                 torch.bfloat16, seed=152)
    prompt = ((torch.arange(BUCKET, device=DEV) + 5) % 1000) + 10
    out["greedy_common_prefix"] = greedy_prefix(
        cfg_s, cfg_m, draft, big, prompt, MIXTRAL_GREEDY_NEW,
        MIXTRAL_GREEDY_GAMMA)
    r = out["results"]
    log(f"mixtral: hsd BE {r['hsd']['be']:.4f} {r['hsd']['tok_s']:.2f} "
        f"tok/s, tokenwise BE {r['tokenwise']['be']:.4f} "
        f"{r['tokenwise']['tok_s']:.2f} tok/s, AR {r['ar_tok_s']:.2f} tok/s")
    return out


def quantize_experts(params, bits, symmetric, perm_seed=None):
    """The MoE expert stacks of a dense model quantized one (layer, expert)
    matrix at a time (`quantize`); with perm_seed each matrix's rows go in
    a random order, kept in an [L, E, in] perm (a desc_act layout)."""
    g = (None if perm_seed is None
         else torch.Generator(device=DEV).manual_seed(perm_seed))
    layers = dict(params.layers)
    for name in ("wgate", "wup", "wdown"):
        w = layers[name]
        L, E, din, _ = w.shape
        qs = []
        for l in range(L):
            for e in range(E):
                p = (None if g is None
                     else torch.randperm(din, generator=g, device=DEV))
                q = quantize(w[l, e] if p is None else w[l, e][p], bits=bits,
                             group_size=group_size(din), symmetric=symmetric)
                qs.append(q._replace(perm=p))
        st = lambda f: (None if getattr(qs[0], f) is None else torch.stack(
            [getattr(q, f) for q in qs]).reshape(
                L, E, *getattr(qs[0], f).shape))
        layers[name] = QuantizedLinear(*(st(f) for f in QuantizedLinear._fields))
    return params._replace(layers=layers)


def greedy_moe_small():
    """Phase 15g: 2-layer float32 MoE targets (4 experts, top-2, D 256,
    F 512, widths the kernels' gates take) with packed-int4 symmetric
    (K1, K3), int8 asymmetric experts (K4) and packed-int4 asymmetric
    experts with desc_act perms (K3): one target forward's launches exactly,
    then greedy hsd, tokenwise and EAGLE-3 == AR."""
    cfg = ModelConfig.tiny_moe(vocab_size=512, hidden_size=256,
                               intermediate_size=512, num_heads=4,
                               num_kv_heads=2, eos_token_id=10**9)
    cfg_d = ModelConfig.tiny(vocab_size=512, hidden_size=256,
                             intermediate_size=512, num_heads=4,
                             num_kv_heads=2, dtype=torch.float32,
                             eos_token_id=10**9)
    draft = quantize_draft(cfg_d, fuse_params(cfg_d, init_params(
        cfg_d, seed=5, device=DEV)), bits=8)
    base = fuse_params(cfg, init_params(cfg, seed=7, device=DEV))
    ecfg = EagleConfig(hidden_size=256, target_hidden_size=256, num_heads=4,
                       num_kv_heads=2, vocab_size=512, draft_vocab_size=512,
                       intermediate_size=512, rope_theta=cfg.rope_theta,
                       top_k=4, depth=3, total_tokens=11,
                       dtype=torch.float32, version=3)
    head = init_eagle_params(ecfg, seed=9, device=DEV)
    L, E = cfg.num_layers, cfg.num_experts
    variants = (
        ("int4 symmetric", init_quantized_params(cfg, seed=6, bits=4,
                                                 device=DEV),
         {"K1": L, "K3": L * (1 + 3 * E) + 1}),
        ("int8 asymmetric experts", quantize_experts(base, 8, False),
         {"K4": L * 3 * E}),
        ("int4 asymmetric experts, desc_act perms",
         quantize_experts(base, 4, False, perm_seed=8), {"K3": L * 3 * E}))
    prompt = (torch.arange(16, device=DEV) % 300) + 3
    eng = EngineConfig(max_new_tokens=32, temperature=0.0)
    for label, target, want in variants:
        _, used = launches_around(lambda: transformer.forward(
            cfg, target, prompt[None, :5], init_cache(cfg, 1, 8, DEV)))
        expect_launches(f"greedy moe ({label}), one 5-row target forward",
                        used, want)
        toks, length = make_autoregressive(cfg, eng)(target, prompt, 12, None)
        ar = toks[16:length].tolist()
        for method in ("hsd", "tokenwise"):
            e = EngineConfig(verifier=VerifierConfig(method=method, gamma=4),
                             max_new_tokens=32, temperature=0.0)
            res = make_generate(cfg_d, cfg, e)(
                draft, target, prompt, 12,
                torch.Generator(device=DEV).manual_seed(3))
            got = res.tokens[16:res.length].tolist()
            log(f"greedy moe ({label}) {method}: {len(got)} tokens, == AR: "
                f"{got == ar}")
            if got != ar or len(got) < 32:
                raise AssertionError(f"greedy moe {method} != AR:\n{got}\n"
                                     f"{ar}")
        res = make_eagle_generate(cfg, ecfg, eng, mode="greedy")(
            target, head, prompt, 12, None)
        got = res.tokens[16:res.length].tolist()
        log(f"greedy moe ({label}) EAGLE-3: {len(got)} tokens in "
            f"{res.blocks} blocks, == AR: {got == ar}")
        if got != ar:
            raise AssertionError(f"greedy EAGLE over MoE != AR:\n{got}\n{ar}")


def write_safetensors(path, tensors):
    """A .safetensors file of numpy arrays: the 8-byte little-endian header
    length, the JSON header (padded to 8 bytes), the raw bytes."""
    codes = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
             np.dtype(np.int32): "I32", np.dtype(np.int64): "I64"}
    header, at = {}, 0
    for name, a in tensors.items():
        header[name] = {"dtype": codes[a.dtype], "shape": list(a.shape),
                        "data_offsets": [at, at + a.nbytes]}
        at += a.nbytes
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little") + h)
        for a in tensors.values():
            np.ascontiguousarray(a).tofile(f)


def gptq_layer(t, rng, name, din, dout, desc_act=False, gs=128):
    """One auto-gptq v1 4-bit layer: int32-packed codes (eight uniform
    nibbles a word) and zero points, f16 scales, g_idx (a permutation of
    the groups' rows with desc_act)."""
    groups = din // gs
    t[name + ".qweight"] = rng.integers(0, 2**32, (din // 8, dout),
                                        dtype=np.uint32).view(np.int32)
    t[name + ".qzeros"] = rng.integers(0, 2**32, (groups, dout // 8),
                                       dtype=np.uint32).view(np.int32)
    t[name + ".scales"] = rng.uniform(2e-3, 1e-2, (groups, dout)).astype(
        np.float16)
    g_idx = np.arange(din) // gs
    t[name + ".g_idx"] = (rng.permutation(g_idx) if desc_act
                          else g_idx).astype(np.int32)


def write_mixtral_checkpoint(path, rng, cfg):
    """A 1-layer Mixtral GPTQ checkpoint at the config's width (auto-gptq
    v1 layout, group 128, desc_act g_idx on expert LOADER_PERM's w2; f16
    embedding, lm_head, norms and router)."""
    D, Fi, V, E = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                   cfg.num_experts)
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    f16 = lambda *shape, s=0.02: (rng.standard_normal(shape, np.float32)
                                  * s).astype(np.float16)
    t = {"model.embed_tokens.weight": f16(V, D), "lm_head.weight": f16(V, D),
         "model.norm.weight": np.ones(D, np.float16)}
    p = "model.layers.0."
    t[p + "input_layernorm.weight"] = np.ones(D, np.float16)
    t[p + "post_attention_layernorm.weight"] = np.ones(D, np.float16)
    for nm, dout, din in (("q_proj", H * hd, D), ("k_proj", Hkv * hd, D),
                          ("v_proj", Hkv * hd, D), ("o_proj", D, H * hd)):
        gptq_layer(t, rng, p + "self_attn." + nm, din, dout)
    t[p + "block_sparse_moe.gate.weight"] = f16(E, D, s=D ** -0.5)
    for e in range(E):
        q = p + f"block_sparse_moe.experts.{e}."
        gptq_layer(t, rng, q + "w1", D, Fi)
        gptq_layer(t, rng, q + "w3", D, Fi)
        gptq_layer(t, rng, q + "w2", Fi, D, desc_act=(e == LOADER_PERM))
    os.makedirs(path)
    write_safetensors(os.path.join(path, "model.safetensors"), t)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(model_type="mixtral", vocab_size=V, hidden_size=D,
                       intermediate_size=Fi, num_hidden_layers=1,
                       num_attention_heads=H, num_key_value_heads=Hkv,
                       rope_theta=cfg.rope_theta,
                       rms_norm_eps=cfg.rms_norm_eps,
                       tie_word_embeddings=False, num_local_experts=E,
                       num_experts_per_tok=cfg.num_experts_per_tok,
                       eos_token_id=cfg.eos_token_id,
                       quantization_config=dict(
                           quant_method="gptq", bits=4, group_size=128,
                           sym=False, desc_act=True)), f)
    return sum(a.nbytes for a in t.values())


def write_eagle3_head(path, rng, D, V, H, Hkv, Fi):
    """A random f16 EAGLE-3 head checkpoint (midlayer.* / fc / norm /
    lm_head) with the full draft vocabulary, and its config.json."""
    hd = D // H
    f16 = lambda *shape: (rng.standard_normal(shape, np.float32)
                          * shape[-1] ** -0.5).astype(np.float16)
    m = "midlayer."
    t = {"fc.weight": f16(D, 3 * D),
         m + "input_layernorm.weight": np.ones(D, np.float16),
         m + "hidden_norm.weight": np.ones(D, np.float16),
         m + "self_attn.q_proj.weight": f16(H * hd, 2 * D),
         m + "self_attn.k_proj.weight": f16(Hkv * hd, 2 * D),
         m + "self_attn.v_proj.weight": f16(Hkv * hd, 2 * D),
         m + "self_attn.o_proj.weight": f16(D, H * hd),
         m + "post_attention_layernorm.weight": np.ones(D, np.float16),
         m + "mlp.gate_proj.weight": f16(Fi, D),
         m + "mlp.up_proj.weight": f16(Fi, D),
         m + "mlp.down_proj.weight": f16(D, Fi),
         "norm.weight": np.ones(D, np.float16), "lm_head.weight": f16(V, D)}
    os.makedirs(path)
    write_safetensors(os.path.join(path, "model.safetensors"), t)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(hidden_size=D, num_attention_heads=H,
                       num_key_value_heads=Hkv, vocab_size=V,
                       draft_vocab_size=V, intermediate_size=Fi,
                       rope_theta=1e6, rms_norm_eps=1e-5), f)


def loaded_moe_check(cfg, lp, x):
    """Layer 0's MoE block of the loaded model on x [n, D]: each expert
    product through apply_linear (exactly one K3 launch) against
    x @ dequantize(w) in f32 on the same input, and `_moe_ffn` (exactly
    3 * E K3 launches) against the plain block: moe_route's weights times
    each expert's SwiGLU of f32 products with the dequantized weights,
    rounded where `_moe_ffn` rounds (each product and silu(g) * u to the
    activation dtype), summed over the experts in f32.
    Returns the worst relative errors (of a product, of the block)."""
    _, _, weights = transformer.moe_route(cfg, lp["gate"], x)
    worst, want_y = 0.0, torch.zeros(x.shape, device=DEV)
    for e in range(cfg.num_experts):
        got, plain = {}, {}
        for name in ("wgate", "wup", "wdown"):
            w = lp[name].layer(e)
            deq = dequantize(w, torch.float32)
            if name == "wdown":
                xin = F.silu(got["wgate"]) * got["wup"]
                pin = F.silu(plain["wgate"]) * plain["wup"]
            else:
                xin = pin = x
            out, used = launches_around(lambda: apply_linear(w, xin))
            if used["K3"] != 1 or sum(used.values()) != 1:
                raise AssertionError(f"loader: expert {e} {name} launched "
                                     f"{used}")
            want = xin.float() @ deq
            err = (out.float() - want).abs().max().item()
            scale = want.abs().max().item()
            worst = max(worst, err / scale)
            if not (math.isfinite(err) and err <= TOL * scale):
                raise AssertionError(f"loader: expert {e} {name} at "
                                     f"{x.shape[0]} rows: {err}")
            got[name], plain[name] = out, (pin.float() @ deq).to(x.dtype)
        want_y += weights[:, e:e + 1] * plain["wdown"].float()
    y, used = launches_around(lambda: transformer._moe_ffn(cfg, lp, x[None]))
    expect_launches(f"loader: layer 0's MoE block at {x.shape[0]} rows",
                    used, {"K3": 3 * cfg.num_experts})
    err = (y[0].float() - want_y).abs().max().item()
    scale = want_y.abs().max().item()
    if not (math.isfinite(err) and err <= TOL * scale):
        raise AssertionError(f"loader: MoE block at {x.shape[0]} rows: "
                             f"{err} > {TOL} x {scale}")
    return worst, err / scale


def loader_phase():
    """Phase 16: a 1-layer Mixtral GPTQ checkpoint at full width written and
    loaded by load_hf onto the card; layer 0's expert products and MoE block
    against their plain versions at 64 and 11 rows of the normed embedding;
    then the phase's own run, its counts zeroed just before: a 64-token
    prefill and an 11-row decode step on the loaded model, and
    Eagle.from_pretrained with an EAGLE-3 head (hsd generate and
    naive_generate). Returns that run's launches."""
    cfg = ModelConfig.mixtral_8x7b()
    rng = np.random.default_rng(LOADER_SEED)
    with tempfile.TemporaryDirectory() as tmp:
        base, hdir = os.path.join(tmp, "base"), os.path.join(tmp, "head")
        t0 = time.time()
        nbytes = write_mixtral_checkpoint(base, rng, cfg)
        write_eagle3_head(hdir, rng, cfg.hidden_size, cfg.vocab_size,
                          cfg.num_heads, cfg.num_kv_heads,
                          cfg.intermediate_size)
        log(f"loader: checkpoints written in {time.time() - t0:.1f}s (base "
            f"{nbytes / 1e9:.3f} GB)")
        t0 = time.time()
        cfg_l, params = load_hf(base, device=DEV)
        torch.cuda.synchronize()
        log(f"loader: load_hf onto the card in {time.time() - t0:.1f}s, "
            f"{param_bytes(params) / 2**30:.2f} GiB")
        w2 = params.layers["wdown"]
        E, Fi, D = cfg.num_experts, cfg.intermediate_size, cfg.hidden_size
        if not (cfg_l.num_layers == 1 and cfg_l.num_experts == E
                and w2.qweight.shape == (1, E, Fi // 2, D)
                and w2.zeros is not None and w2.perm is not None):
            raise AssertionError(f"loader: unexpected layout {cfg_l} "
                                 f"{tuple(w2.qweight.shape)}")
        toks = ((torch.arange(BUCKET + MIXTRAL_VERIFY, device=DEV) * 11)
                % (cfg.vocab_size - 100) + 100)[None]
        h = rms_norm(transformer._embed(cfg_l, params.embed, toks[0]),
                     params.layers["ln2"][0], cfg_l.rms_norm_eps)
        lp = transformer.moe_params(params.layers, 0)
        errs = [loaded_moe_check(cfg_l, lp, h[:BUCKET]),
                loaded_moe_check(cfg_l, lp, h[BUCKET:])]
        log(f"loader: every expert product of layer 0 (K3 with zero points;"
            f" expert {LOADER_PERM}'s w2 with its perm) and the MoE block "
            f"within tolerance at {BUCKET} and {MIXTRAL_VERIFY} rows (worst "
            f"rel: a product {max(e[0] for e in errs):.2e}, the block "
            f"{max(e[1] for e in errs):.2e}; tol {TOL:.2e})")
        del h, lp, w2

        reset_launches()
        cache = init_cache(cfg_l, 1, 2 * BUCKET, DEV)
        for part in (toks[:, :BUCKET], toks[:, BUCKET:]):
            logits, cache = transformer.forward(cfg_l, params, part, cache)
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError("loader: logits not finite")
        del params, cache, logits
        torch.cuda.empty_cache()
        t0 = time.time()
        eagle = Eagle.from_pretrained(base, hdir, device=DEV)
        log(f"loader: Eagle.from_pretrained in {time.time() - t0:.1f}s")
        prompt = (torch.arange(32) * 13 % (cfg.vocab_size - 100)
                  + 100).tolist()
        res = eagle.generate(prompt, max_new_tokens=32,
                             generator=torch.Generator(device=DEV)
                             .manual_seed(16))
        _, length = eagle.naive_generate(prompt, max_new_tokens=32)
        torch.cuda.synchronize()
        used = launch_counts()
        out = res.tokens[len(prompt):res.length]
        acc = res.accepts[:res.blocks]
        if not (res.ncommit >= 1 and int(out.min()) >= 0
                and int(out.max()) < cfg.vocab_size
                and int(acc.min()) >= 0
                and int(acc.max()) <= eagle.ecfg.depth):
            raise AssertionError(f"loader: Eagle.generate gave {res}")
        if length <= len(prompt):
            raise AssertionError("loader: naive_generate committed nothing")
        log(f"loader: Eagle.generate (hsd) {res.ncommit} tokens in "
            f"{res.blocks} blocks (accepts {acc.tolist()}); naive_generate "
            f"{length - len(prompt)} tokens")
        del eagle
        torch.cuda.empty_cache()
    log(f"loader: launches of the prefill, the decode step, generate and "
        f"naive_generate {used}")
    if used["K3"] <= 0:
        raise AssertionError("loader: K3 never launched")
    return used


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", action="store_true",
                    help="also profile a short hsd generate (device time by "
                         "kernel, idle share) and time the host cost per call")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.time()
    _build.lib("gptq_i8")        # builds every csrc/*.cu, one nvcc each
    _build.lib("gptq_mma")
    _build.lib("flash_decode")
    # the K8 routes are opt-in: off unless a phase below turns one on
    FD.FLASH_DECODE = FD.FUSED_ATTN = "auto"
    log(f"kernels built and loaded in {time.time() - t0:.1f}s")

    cfg_s = ModelConfig.qwen2_05b()
    cfg_b = ModelConfig.qwen2_14b()
    t0 = time.time()
    draft, target = build_coupled_pair(0, cfg_s, cfg_b, lam=0.0,
                                       logit_scale=LOGIT_SCALE, device=DEV)
    torch.cuda.synchronize()
    log(f"coupled pair built in {time.time() - t0:.1f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    kernel_phase(draft, target, cfg_b)
    attention_phase()
    mlp_counts = mlp_phase(target, cfg_b)
    results, counts = main_path(draft, target, cfg_s, cfg_b, args.trace)
    # full-width greedy: report only the common prefix of spec and AR
    prompt = ((torch.arange(BUCKET, device=DEV)) % 1000) + 10
    results["greedy_common_prefix"] = greedy_prefix(
        cfg_s, cfg_b, draft, target, prompt, 32, GAMMA,
        *make_coupled_target(cfg_s, cfg_b))
    opted = opted_in_main_path(draft, target, cfg_s, cfg_b, results)
    engines = engines_phase(draft, target, cfg_s, cfg_b)
    longctx = long_context_phase(target, cfg_b)
    striped = striped_phase(draft, target, cfg_s, cfg_b)
    spec_serving = serving_phase(draft, target, cfg_s, args.trace)
    uad = uad_phase(target, cfg_b)
    evals = eval_phase(draft, target, cfg_s, cfg_b)
    greedy_small()

    del draft, target
    torch.cuda.empty_cache()
    cfg_e, ecfg = BM.eagle_configs()
    t0 = time.time()
    head, etarget = build_coupled_eagle_pair(0, cfg_e, ecfg, scale=6.0,
                                             lam=1.312, big_bits=8,
                                             device=DEV)
    torch.cuda.synchronize()
    log(f"EAGLE pair built in {time.time() - t0:.1f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    eagle_kernel_phase(etarget, cfg_e)
    serving = eagle_serving(etarget, head, cfg_e, ecfg, args.trace)
    eagle1 = eagle_single(etarget, head, cfg_e, ecfg)
    train = train_phase(etarget.big, cfg_e)
    del head, etarget
    torch.cuda.empty_cache()
    eagle_greedy_small()
    greedy_k8()

    t0 = time.time()
    head, etarget = build_coupled_eagle_pair(0, cfg_e, ecfg, scale=6.0,
                                             lam=1.312, big_bits=4,
                                             device=DEV)
    torch.cuda.synchronize()
    log(f"int4 EAGLE pair built in {time.time() - t0:.1f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    int4_eagle_kernel_phase(etarget, cfg_e)
    serving4 = eagle_serving(etarget, head, cfg_e, ecfg, args.trace,
                             launched=("K1", "K3", "K7i4"),
                             absent=("K4", "K5", "K7", "K8"),
                             label="int4 eagle")
    log("int4 eagle serving: " + ", ".join(
        f"{m} BE {serving4[m]['be']:.4f} over {serving4[m]['blocks']} "
        f"slot-blocks (the int8 pair's {serving[m]['be']:.4f} over "
        f"{serving[m]['blocks']})" for m in ("hsd_ref", "hsd")))
    del head
    eagle3 = eagle3_phase(etarget.big, cfg_e)
    del etarget
    torch.cuda.empty_cache()
    eagle_greedy_v3_small()

    mixtral = mixtral_phase(args.trace)
    torch.cuda.empty_cache()
    greedy_moe_small()
    loader_counts = loader_phase()
    oracle = oracle_phase()

    src_i8 = "hsd_tpu_torch/csrc/gptq_i8.cu"
    ecounts = serving["hsd_ref"]["launches"]
    # K6 and K8 over the opted-in runs of phases 5c-5e and 9f (K6: 0, the
    # tail K2 fuses wherever it could); K6's route is phase 4b's apply_mlp
    opted_counts = [opted["FUSED_ATTN"]["counts"],
                    opted["FLASH_DECODE"]["counts"], engines["counts"],
                    longctx["counts"], eagle1["counts"]]
    k6k8 = {k: sum(c[k] for c in opted_counts) for k in ("K6", "K8")}
    kernels = [
        summary_entry("K1", "target wqkv 5120x7168", 11, src_i8,
                      "hsd_tpu/ops/gptq_pallas.py:176", counts["K1"]),
        summary_entry("K2", "target tail 5120/27648/13824", 11, src_i8,
                      "hsd_tpu/ops/gptq_pallas.py:617", counts["K2"]),
        summary_entry("K3", "target lm_head 5120x151936", 11, src_i8,
                      "hsd_tpu/ops/gptq_pallas.py:117", counts["K3"]),
        summary_entry("K4", "draft wgu 896x9728", 1, src_i8,
                      "hsd_tpu/ops/gptq_pallas.py:44", counts["K4"]),
        summary_entry("K5", "wqkv 4096x6144", 60, src_i8,
                      "hsd_tpu/ops/gptq_pallas.py:83", ecounts["K5"]),
        summary_entry("K6", "target mlp 5120/27648/13824", 11, src_i8,
                      "hsd_tpu/ops/gptq_pallas.py:530", mlp_counts["K6"]),
        summary_entry("K7", "wgu 4096x28672 +norm", EAGLE_SLOTS * 60,
                      "hsd_tpu_torch/csrc/gptq_mma.cu",
                      "hsd_tpu/ops/gptq_pallas.py:102", ecounts["K7"]),
        summary_entry("K8", *K8_REP, "hsd_tpu_torch/csrc/flash_decode.cu",
                      "hsd_tpu/ops/flash_decode.py:49", k6k8["K8"]),
        dict(summary_entry("K7i4", "wgu 4096x28672 +norm", EAGLE_SLOTS * 60,
                           "hsd_tpu_torch/csrc/gptq_mma.cu",
                           "hsd_tpu/ops/gptq_pallas.py:176",
                           serving4["hsd_ref"]["launches"]["K7i4"]),
             also_replaces="hsd_tpu/ops/gptq_pallas.py:117"),
    ]
    log(f"main path: hsd BE {results['hsd']['be']:.4f} "
        f"{results['hsd']['tok_s']:.2f} tok/s, tokenwise BE "
        f"{results['tokenwise']['be']:.4f} "
        f"{results['tokenwise']['tok_s']:.2f} tok/s, AR "
        f"{results['ar_tok_s']:.2f} tok/s")
    log("eagle serving: " + ", ".join(
        f"{m} BE {serving[m]['be']:.4f} {serving[m]['tok_s']:.2f} tok/s"
        for m in ("hsd_ref", "hsd")))
    log("opted in: " + ", ".join(
        f"hsd {a} BE {opted[a]['be']:.4f} "
        f"{statistics.mean(opted[a]['tok_s']):.2f} tok/s"
        for a in ("off", "FUSED_ATTN", "FLASH_DECODE"))
        + f"; eagle single request BE {eagle1['be']:.4f} "
        f"{eagle1['tok_s']:.2f} tok/s; K6/K8 launches {k6k8}; K6 through "
        f"apply_mlp (phase 4b) {mlp_counts['K6']}")
    log("int4 eagle serving: " + ", ".join(
        f"{m} BE {serving4[m]['be']:.4f} {serving4[m]['tok_s']:.2f} tok/s"
        for m in ("hsd_ref", "hsd"))
        + f"; eagle-3 head BE {eagle3['be']:.4f} {eagle3['tok_s']:.2f} "
        "tok/s")
    log("striped (K 2, 11 rows): " + ", ".join(
        f"{m} BE {striped[m]['be']:.4f}" for m in ("hsd", "tokenwise",
                                                   "hsd_ref")))
    log(f"slot serving (5g): BE {spec_serving['be']:.4f} "
        f"{spec_serving['tok_s']:.2f} tok/s, launches "
        f"{spec_serving['counts']}; uad (5h): {uad['tokens']} tokens "
        f"{uad['tokens'] / uad['secs']:.2f} tok/s, launches {uad['counts']}")
    mr = mixtral["results"]
    log(f"mixtral (15): trunk {mixtral['trunk_gib']:.2f} GiB, hsd BE "
        f"{mr['hsd']['be']:.4f} {mr['hsd']['tok_s']:.2f} tok/s, tokenwise BE "
        f"{mr['tokenwise']['be']:.4f} {mr['tokenwise']['tok_s']:.2f} tok/s, "
        f"AR {mr['ar_tok_s']:.2f} tok/s; an {MIXTRAL_VERIFY}-row verify "
        f"{mixtral['verify']['wall_ms']:.2f} ms wall, "
        f"{mixtral['verify']['device_ms']:.3f} ms device; greedy common "
        f"prefix {mixtral['greedy_common_prefix']} of {MIXTRAL_GREEDY_NEW}")
    e0 = evals["prefill"]
    log(f"eval (5i): GSM8K hsd BE {evals['be']:.4f} in {evals['secs']:.2f}s, "
        f"launches {evals['counts']}; multi-bench BE {evals['bench_be']:.4f};"
        f" the 2047-row target prefill {e0['target']['ms']:.2f} ms, "
        f"{e0['target']['peak_gib']:.3f} GiB; oracle (17): CEs "
        f"{oracle['target_ce']:.4f} / {oracle['distill_ce']:.4f}, tokenwise "
        f"BE {oracle['tokenwise']:.4f}, hsd BE {oracle['hsd']:.4f}")
    log(f"train (18): EAGLE-3 {TRAIN_B} x {TRAIN_T} loss "
        f"{train['losses'][0]:.4f} -> {train['losses'][-1]:.4f}, "
        f"{train['step_ms']:.2f} ms a step, {train['tok_s']:.1f} tokens/s, "
        f"peak {train['peak_gib']:.2f} GiB, K7 {train['k7_per_forward']:.1f} "
        f"a target forward; 1 x {TRAIN_LONG} {train['long_ms']:.2f} ms, peak "
        f"{train['long_peak_gib']:.2f} GiB; the raw shard's non-finite "
        f"share {train['raw_shard']['nonfinite']:.4f}; offline vs online "
        f"{train['offline_rel']:.2e} ({train['f16_flips']} argmaxes moved), "
        f"vs the f16-rounded inputs {train['offline_exact']:.2e}; EAGLE-1 "
        f"losses "
        f"{[round(x, 4) for x in train['eagle1_losses']]}; kacc "
        f"{train['kacc']}; checkpoint {train['ckpt_bytes']} bytes saved "
        f"{train['ckpt_save_s']:.2f}s, restored "
        f"{train['ckpt_restore_s']:.2f}s")
    # each path's own launches: phase 5 (the "launches" key), 5g, 5h, 5i
    # (run_eval's GSM8K run), 15 (the Mixtral hsd + tokenwise runs), 16
    # (the loader phase), 17 (the oracle pair: none) and 18 (the EAGLE-3
    # online training steps)
    for k in kernels:
        k["launches_by_phase"] = {
            "5": counts[k["name"]], "5g": spec_serving["counts"][k["name"]],
            "5h": uad["counts"][k["name"]],
            "5i": evals["counts"][k["name"]],
            "15": mixtral["counts"][k["name"]],
            "16": loader_counts[k["name"]],
            "17": oracle["counts"][k["name"]],
            "18": train["counts"][k["name"]]}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
