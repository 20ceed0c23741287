"""GPTQ dequantize-and-matmul kernels for the H100: the port's counterpart of
`hsd_tpu/ops/gptq_pallas.py`.

One wrapper for each Pallas kernel that the port's paths reach (K1-K7,
K7i4), and two for route A's dequantize (`dequantize_int4`,
`dequantize_int8`: `csrc/dequant.cu`, which replaces no Pallas kernel; the
JAX package dequantizes in XLA code there). Each has:
  * a plain PyTorch version beside it (`*_plain`), which the wrapper runs
    only for tensors on the CPU; on a CUDA tensor the wrapper launches the
    kernel or raises, never the plain version;
  * a launch counter, `<wrapper>.launches`, raised by one where the wrapper
    launches its kernel and nowhere else (`hsd_tpu_torch.ops.launch_counts()`
    reads every kernel's, `reset_launches()` zeroes them);
  * a note naming the TPU kernel it replaces and what bounds it on the card.

K1 and K3 (packed int4) and K4 and K5 (int8), the f32-operand products, are
the tensor-core kernel of `csrc/gptq_i8.cu`: f32 activations split into
three bf16 planes that sum to them exactly, so the products stay exact.
K2 and K6 (packed int4, the fused layer tail and MLP) are three and two
products of the same kernel, each finished by an epilogue pass (the
residual, the SwiGLU). K7 (int8) and K7i4 (packed int4) are the
tensor-core kernels of `csrc/gptq_mma.cu` for the bf16-operand mode at
129-1024 rows. In both files, nothing in an output's summation order
depends on the row count, so a row's bits do not either.

Layouts are those of `ops/linear.QuantizedLinear`: packed int4 is uint8
[din/2, dout] split-half with nibbles stored as code+8; int8 is [din, dout];
scales (bf16 or f32, read as they are) and zeros (f32) are [groups, dout].
Weights are 2-D here: the caller selects a layer of a stacked weight with
`qweight[l]`, a view.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

# Row gate of the fused layer tail (gptq_pallas.attn_mlp_fusion_supported):
# the tail fuses at decode and verify row counts only.
TAIL_MAX_ROWS = 32


# --------------------------------------------------------------------------
# plain versions (reference arithmetic; f32 throughout, one rounding at the end)

def dequantize_int4_plain(qweight: torch.Tensor, scales: torch.Tensor,
                          zeros: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Packed int4 [din/2, dout] -> f32 [din, dout] weight
    (nibble - 8 - zero) * scale, split-half rows."""
    return _apply_groups(_nibbles(qweight).sub_(8), scales, zeros)


def dequantize_int8_plain(qweight: torch.Tensor, scales: torch.Tensor,
                          zeros: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """int8 codes [din, dout] -> f32 [din, dout] weight (code - zero) * scale."""
    return _apply_groups(qweight.float(), scales, zeros)


def _apply_groups(codes, scales, zeros):
    """(codes - zero) * scale per group, in place on the f32 codes (one
    [din, dout] f32 buffer: the dequantize route above 128 rows runs this on
    a whole head)."""
    din, dout = codes.shape
    g = scales.shape[0]
    c = codes.reshape(g, din // g, dout)
    if zeros is not None:
        c.sub_(zeros.float()[:, None, :])
    return c.mul_(scales.float()[:, None, :]).reshape(din, dout)


def _inv_rms(xf: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)


def _rms_f32(x: torch.Tensor, ln: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return xf * _inv_rms(xf, eps) * ln.float()


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _nibbles(qweight: torch.Tensor) -> torch.Tensor:
    """Packed int4 [din/2, dout] -> the stored UNSIGNED nibbles (code + 8,
    0..15) as f32 [din, dout], split-half rows."""
    rows = qweight.shape[0]
    out = torch.empty((2 * rows, qweight.shape[1]), dtype=torch.float32,
                      device=qweight.device)
    out[:rows] = qweight & 15
    out[rows:] = qweight >> 4
    return out


def _bf16_weight(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The bf16-operand mode's staged weight: bf16(code * f32(scale)), codes
    as stored (unsigned nibbles for int4), no zero point."""
    din, dout = codes.shape
    g = scales.shape[0]
    w = codes.reshape(g, din // g, dout) * scales.float()[:, None, :]
    return _bf16_round(w.reshape(din, dout))


def _group_sums(xf: torch.Tensor, groups: int) -> torch.Tensor:
    """[n, groups] sums of the f32 activations over each group's rows."""
    n, din = xf.shape
    return xf.reshape(n, groups, din // groups).sum(-1)


def _correction(xf: torch.Tensor, scales: torch.Tensor,
                zeros: Optional[torch.Tensor], offset: float,
                xg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_g xg * (zero + offset) * scale in f32, xg the group sums of the
    UNROUNDED f32 activations (gptq_pallas.py:515-525; given, or those of
    xf): the uniform -8 of the unsigned nibbles (offset 8) and the zero
    points, which the bf16-operand mode subtracts after its f32
    accumulation."""
    if xg is None:
        xg = _group_sums(xf, scales.shape[0])
    z = offset if zeros is None else zeros.float() + offset
    return xg @ (z * scales.float())


def int4_ln_matmul_plain(x, qweight, scales, ln, eps, bf16_operands=False):
    """rmsnorm(x, ln) @ deq(W), packed int4, symmetric: int4_matmul_plain
    on the f32 normed x (the norm is never rounded), rounded once."""
    return int4_matmul_plain(_rms_f32(x, ln, eps), qweight, scales,
                             bf16_operands=bf16_operands).to(x.dtype)


def int4_matmul_plain(x, qweight, scales, zeros=None, bf16_operands=False,
                      xg=None):
    """x @ deq(W), packed int4, f32 with one rounding at the end.
    bf16_operands: the mxu_bf16 mode of _kernel_int4 (gptq_pallas.py:
    157-169) and its correction (:515-526): bf16(x) @ bf16(nibble * scale)
    with the UNSIGNED nibble, f32 accumulation, then the f32 correction
    sum_g xg * (zero + 8) * scale on the unrounded x, rounded once. xg: the
    group sums to correct with in place of x's own (K7i4's pre-pass hands
    the main kernel those of the unrounded normed rows with xn)."""
    xf = x.float()
    if not bf16_operands:
        w = dequantize_int4_plain(qweight, scales, zeros)
        return (xf @ w).to(x.dtype)
    y = (_bf16_round(xf) @ _bf16_weight(_nibbles(qweight), scales)
         - _correction(xf, scales, zeros, 8.0, xg))
    return y.to(x.dtype)


def int8_matmul_plain(x, qweight, scales, zeros=None, bf16_operands=False):
    """x @ deq(W) in f32. bf16_operands: K7's arithmetic, both operands
    rounded to bf16 (the weight after code * scale), f32 accumulation; a
    zero point is subtracted afterwards as the f32 correction
    sum_g xg * zero * scale on the unrounded x."""
    xf = x.float()
    if not bf16_operands:
        w = dequantize_int8_plain(qweight, scales, zeros)
        return (xf @ w).to(x.dtype)
    y = _bf16_round(xf) @ _bf16_weight(qweight.float(), scales)
    if zeros is not None:
        y = y - _correction(xf, scales, zeros, 0.0)
    return y.to(x.dtype)


def int8_ln_matmul_plain(x, qweight, scales, ln, eps, bf16_operands=False):
    """rmsnorm(x, ln) @ deq(W), symmetric int8: int8_matmul_plain on the
    f32 normed x (the norm is never rounded), rounded once."""
    return int8_matmul_plain(_rms_f32(x, ln, eps), qweight, scales,
                             bf16_operands=bf16_operands).to(x.dtype)


def k7_stage_plain(x, ln, eps, groups=None):
    """K7's and K7i4's pre-pass: each row's inverse RMS inv [n] (f32) and
    its normed activations xn = bf16((x * inv) * ln) [n, din], the bf16
    operand that the ln forms (bf16_operands=True) round their f32 normed x
    to; with `groups`, also the group sums xg [n, groups] of the unrounded
    normed rows, which K7i4's correction takes. int8_matmul_plain(xn,
    bf16_operands=True) is int8_ln_matmul_plain's product, and
    int4_matmul_plain(xn, bf16_operands=True, xg=xg) int4_ln_matmul_plain's,
    bit for bit."""
    xf = x.float()
    inv = _inv_rms(xf, eps)
    xs = xf * inv * ln.float()
    if groups is None:
        return inv[:, 0], xs.to(torch.bfloat16)
    return inv[:, 0], xs.to(torch.bfloat16), _group_sums(xs, groups)


def attn_mlp_int4_plain(att, resid, wo, so, wgu, sg, wdown, sd, ln, eps):
    # x' kept f32
    xp = resid.float() + att.float() @ dequantize_int4_plain(wo, so)
    gu = _rms_f32(xp, ln, eps) @ dequantize_int4_plain(wgu, sg)
    f = gu.shape[-1] // 2
    ff = F.silu(gu[:, :f]) * gu[:, f:]
    return (xp + ff @ dequantize_int4_plain(wdown, sd)).to(resid.dtype)


def mlp_int4_plain(x, wgu, sg, wdown, sd, ln, eps):
    gu = _rms_f32(x, ln, eps) @ dequantize_int4_plain(wgu, sg)
    f = gu.shape[-1] // 2
    ff = F.silu(gu[:, :f]) * gu[:, f:]
    return (ff @ dequantize_int4_plain(wdown, sd)).to(x.dtype)


# --------------------------------------------------------------------------
# launch plumbing

_ACT = (torch.float32, torch.bfloat16)


def _check(t: torch.Tensor, name: str, dtypes, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def _weight(qweight, scales, zeros, packed: bool, din: int, dout: int):
    _check(qweight, "qweight", (torch.uint8,) if packed else (torch.int8,),
           (din // 2 if packed else din, dout))
    _check(scales, "scales", _ACT)
    if scales.dim() != 2 or scales.shape[1] != dout:
        raise ValueError(f"scales: shape {tuple(scales.shape)} for dout {dout}")
    if zeros is not None:
        _check(zeros, "zeros", (torch.float32,), scales.shape)
    if dout % 4 == 0 and qweight.data_ptr() % 4:
        raise ValueError("qweight: rows must start 4-byte aligned")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _bf16(t: Optional[torch.Tensor]) -> int:
    return int(t is not None and t.dtype == torch.bfloat16)


# The split unit (in packed rows for int4) and the column block:
# csrc/gptq_i8.cu kTileRows, BN.
TILE_ROWS, BLOCK_COLS = 128, 128


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits_for(weight_rows: int, dout: int, sms: int) -> int:
    """Input-dimension splits for a weight: enough blocks for about two per
    SM. Depends on the weight's shape and the card only, never on the row
    count, so a row's reduction order (and bits) is the same at any n."""
    tiles = max(1, weight_rows // TILE_ROWS)   # the kernel rejects < 1 tile
    col_blocks = -(-dout // BLOCK_COLS)
    want = min(tiles, max(1, -(-2 * sms // col_blocks)))
    per_split = -(-tiles // want)
    return -(-tiles // per_split)


# --------------------------------------------------------------------------
# K1, K3, K4 and K5 — one tensor-core kernel, `csrc/gptq_i8.cu` (see its
# header), with f32-exact operands: f32 activations split into three bf16
# planes (hi, mid, lo) that sum to them exactly, bf16 activations are one
# plane, int8 codes and the stored int4 nibbles are exact in bf16, so each
# mma.sync product is exact and only the f32 accumulation rounds. A group's
# code sums take the offset as the rank-1 term acc - c * xg (c: the int8
# zero point, or 8 + zero for the unsigned nibbles) and join the output as
# fmaf(scale, acc, out), groups in order. A block owns 128 columns for every
# row up to 128 (int8) or 32 (int4, whose row blocks run side by side and
# share the weight through L2), so the weight streams once per call. Splits of the input dimension come from
# `splits_for` on the weight's rows (the weight's shape and the card only),
# summed in order by a second launch. K5 and K1 add a per-row pre-pass
# first, which writes the inverse RMS's normed activations as three planes
# (a [3, n, din] bf16 workspace), and for K1 each group's sum of them after
# the planes ([n, groups] f32) in place of the ones column's mma.

def _launch_i8(x, qweight, scales, zeros, ln, eps, packed=False):
    n, din = x.shape
    dout = qweight.shape[-1]
    _check(x, "x", _ACT)
    if x.data_ptr() % 16:
        raise ValueError("x: must start 16-byte aligned")
    if ln is not None:
        _check(ln, "ln", (torch.float32,), (din,))
    _weight(qweight, scales, zeros, packed, din, dout)
    dev = x.device
    splits = splits_for(qweight.shape[0], dout, _sm_count(dev.index or 0))
    out = torch.empty((n, dout), dtype=x.dtype, device=dev)
    ws = (torch.empty((splits, n, dout), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    # K1: the group sums, [n, groups] f32, after the planes
    extra = 2 * n * scales.shape[0] if packed else 0
    planes = (torch.empty((3 * n * din + extra,), dtype=torch.bfloat16,
                          device=dev) if ln is not None else None)
    lib = _build.lib("gptq_i8")
    err = (lib.hsd_gptq_i4 if packed else lib.hsd_gptq_i8)(
        _ptr(x), _bf16(x), n, din, _ptr(qweight), dout, _ptr(scales),
        _bf16(scales), _ptr(zeros), scales.shape[0], _ptr(ln), float(eps),
        _ptr(out), _bf16(out), splits, _ptr(ws), _ptr(planes),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{'int4' if packed else 'int8'} GPTQ kernel "
                           f"(n={n}, din={din}, dout={dout}, ln="
                           f"{ln is not None}, zeros={zeros is not None}): "
                           f"{lib.hsd_i8_error_string(err).decode()}")
    return out


# K1 — replaces gptq_pallas.gptq_matmul(..., ln=) packed: _kernel_int4_ln
# (hsd_tpu/ops/gptq_pallas.py:176). y = rmsnorm(x, ln) @ deq(W), the normed
# x kept f32 (three planes from the pre-pass), the -8 as the rank-1 term on
# the normed group sums.
# Bound: the weight stream at 1-11 rows (target wqkv 2560 x 7168: 18.4 MB +
# 0.6 MB of scales, ~5.6 us at 3.35 TB/s); the three planes' operations at
# the 60-128-row prefill and verify calls.

def int4_ln_matmul(x: torch.Tensor, qweight: torch.Tensor,
                   scales: torch.Tensor, ln: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """y[n, dout] = rmsnorm(x[n, din], ln) @ deq(qweight): packed int4,
    symmetric (no zeros)."""
    if not x.is_cuda:
        return int4_ln_matmul_plain(x, qweight, scales, ln, eps)
    out = _launch_i8(x, qweight, scales, None, ln, eps, packed=True)
    int4_ln_matmul.launches += 1
    return out


# K3 — replaces gptq_pallas.gptq_matmul packed without ln: _kernel_int4
# (gptq_pallas.py:117) plus its rank-1 -8 / zero-point correction
# (:500-526). y = x @ deq(W).
# Bound: the weight stream at 1-11 rows (target lm_head 2560 x 151936: 389
# MB + 12 MB of scales, ~120 us at 3.35 TB/s); the operations at the
# 60-128-row calls (one plane of bf16 mma for bf16 x, three for f32).

def int4_matmul(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                zeros: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[n, dout] = x[n, din] @ deq(qweight): packed int4."""
    if not x.is_cuda:
        return int4_matmul_plain(x, qweight, scales, zeros)
    out = _launch_i8(x, qweight, scales, zeros, None, 0.0, packed=True)
    int4_matmul.launches += 1
    return out


# K4 — replaces gptq_pallas.gptq_matmul int8: _kernel (gptq_pallas.py:44)
# plus its rank-1 zero-point correction (:500-526). y = x @ deq(W).
# Bound: the weight stream plus scales and zeros at decode rows (one 0.5B
# draft layer, 896 x 1152 + 896 x 896 + 896 x 9728 + 4864 x 896: 14.9 MB,
# ~4.4 us at 3.35 TB/s); the operations at the 64-80-row prefill and
# EAGLE-3 beam calls (one plane of bf16 mma for bf16 x, three for f32).

def int8_matmul(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                zeros: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[n, dout] = x[n, din] @ deq(qweight): int8 codes, optional zeros."""
    if not x.is_cuda:
        return int8_matmul_plain(x, qweight, scales, zeros)
    out = _launch_i8(x, qweight, scales, zeros, None, 0.0)
    int8_matmul.launches += 1
    return out


# --------------------------------------------------------------------------
# K2 and K6 — the fused layer tail and MLP, three and two products of the
# int4 kernel in one C call (`hsd_gptq_tail`, csrc/gptq_i8.cu): wo on the
# activations' planes (bf16: one; f32: split in the kernel), wgu on the
# three planes and group sums of K1's pre-pass over x' (K6: over x), wdown
# on the f32 ff split in the kernel. Each product writes f32 partials into
# one buffer (a product that runs unsplit writes its single partial there),
# and an epilogue pass sums them in split order and finishes: x' = resid +
# the sum, kept f32; ff = silu(g) * u, pairing columns j and F + j; out =
# x' + the sum (K6: the sum), rounded once. x', the planes, the group sums,
# ff and the partials are one workspace, one allocation a call beside the
# output; 7 launches for K2 and 5 for K6. Splits come from each weight's
# shape (`splits_for`), so a row's bits do not depend on the row count.

@functools.lru_cache(maxsize=None)
def _tail_ws_bytes(*dims) -> int:
    return _build.lib("gptq_i8").hsd_tail_workspace(*dims)


def _tail(x, resid, wo, so, wgu, sg, wdown, sd, ln, eps, out_dtype):
    """The C call behind K2 (wo, so and resid given) and K6 (None)."""
    n, din = x.shape
    k2 = wo is not None
    d = wgu.shape[0] * 2
    f = wdown.shape[0] * 2
    dout = wdown.shape[-1]
    if wgu.shape[-1] != 2 * f or (k2 and (wo.shape[-1] != d or dout != d)):
        raise ValueError(f"inconsistent {'tail' if k2 else 'MLP'} shapes: "
                         f"wo {None if wo is None else tuple(wo.shape)}, wgu "
                         f"{tuple(wgu.shape)}, wdown {tuple(wdown.shape)}")
    _check(x, "x", _ACT)
    if x.data_ptr() % 16:
        raise ValueError("x: must start 16-byte aligned")
    if k2:
        _check(resid, "resid", _ACT, (n, d))
        _weight(wo, so, None, True, din, d)
    elif din != d:
        raise ValueError(f"x: width {din} != {d}")
    _check(ln, "ln", (torch.float32,), (d,))
    _weight(wgu, sg, None, True, d, 2 * f)
    _weight(wdown, sd, None, True, f, dout)
    dev = x.device
    sms = _sm_count(dev.index or 0)
    splits = [splits_for(w.shape[0], w.shape[-1], sms) if w is not None else 1
              for w in (wo, wgu, wdown)]
    dh = din if k2 else 0
    ws_bytes = _tail_ws_bytes(n, dh, d, f, dout, sg.shape[0], *splits)
    ws = torch.empty((ws_bytes,), dtype=torch.uint8, device=dev)
    out = torch.empty((n, dout), dtype=out_dtype, device=dev)
    lib = _build.lib("gptq_i8")
    err = lib.hsd_gptq_tail(
        _ptr(x), _bf16(x), _ptr(resid), _bf16(resid), n, dh, d, f, dout,
        _ptr(wo), _ptr(so), _bf16(so), so.shape[0] if k2 else 0, splits[0],
        _ptr(wgu), _ptr(sg), _bf16(sg), sg.shape[0], splits[1],
        _ptr(wdown), _ptr(sd), _bf16(sd), sd.shape[0], splits[2],
        _ptr(ln), float(eps), _ptr(out), _bf16(out), _ptr(ws), ws_bytes,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"int4 {'tail' if k2 else 'MLP'} kernel (n={n}, "
                           f"d={d}, f={f}, dout={dout}): "
                           f"{lib.hsd_i8_error_string(err).decode()}")
    return out


# K2 — replaces gptq_pallas.gptq_attn_mlp_int4: _kernel_attn_mlp_int4
# (gptq_pallas.py:617). x' = resid + att @ deq(Wo), kept f32;
# [g|u] = rmsnorm(x', ln) @ deq(Wgu); out = x' + (silu(g) * u) @ deq(Wdown).
# Bound: three weight streams (14B layer: 13.1 + 70.8 + 35.4 MB + scales,
# ~123 MB, ~37 us at 3.35 TB/s). The counter counts one call per tail.

def attn_mlp_int4(att: torch.Tensor, resid: torch.Tensor,
                  wo: torch.Tensor, so: torch.Tensor,
                  wgu: torch.Tensor, sg: torch.Tensor,
                  wdown: torch.Tensor, sd: torch.Tensor,
                  ln: torch.Tensor, eps: float) -> torch.Tensor:
    """The fused layer tail; att [n, Dh], resid [n, D] -> [n, D] in
    resid.dtype. All three weights packed int4, symmetric."""
    if not att.is_cuda:
        return attn_mlp_int4_plain(att, resid, wo, so, wgu, sg, wdown, sd,
                                   ln, eps)
    out = _tail(att, resid, wo, so, wgu, sg, wdown, sd, ln, eps,
                resid.dtype)
    attn_mlp_int4.launches += 1
    return out


# --------------------------------------------------------------------------
# K6 — replaces gptq_pallas.gptq_mlp_int4: _kernel_mlp_int4
# (gptq_pallas.py:530). [g|u] = rmsnorm(x, ln) @ deq(Wgu), kept f32;
# out = (silu(g) * u) @ deq(Wdown), rounded once. The SwiGLU MLP without
# its residual: K2's last two products, wgu's pre-pass on x itself.
# Bound: two weight streams (14B layer: 70.8 + 35.4 MB + scales, ~33 us at
# 3.35 TB/s). The counter counts one call per MLP.

def mlp_int4(x: torch.Tensor, wgu: torch.Tensor, sg: torch.Tensor,
             wdown: torch.Tensor, sd: torch.Tensor, ln: torch.Tensor,
             eps: float) -> torch.Tensor:
    """The fused SwiGLU MLP; x [n, D] -> [n, dout] in x.dtype. Both weights
    packed int4, symmetric."""
    if not x.is_cuda:
        return mlp_int4_plain(x, wgu, sg, wdown, sd, ln, eps)
    out = _tail(x, None, None, None, wgu, sg, wdown, sd, ln, eps, x.dtype)
    mlp_int4.launches += 1
    return out


# --------------------------------------------------------------------------
# K5 — replaces gptq_pallas.gptq_matmul(..., ln=) int8: _kernel_ln
# (gptq_pallas.py:83). y = rmsnorm(x, ln) @ (code * scale), symmetric: K4's
# kernel on the three planes of the f32 normed activations, which the
# per-row pre-pass writes once (6 bytes a feature) instead of every column
# block norming and splitting them again.
# Bound: the weight stream at 1 row (Llama-3.1-8B wqkv 4096 x 6144: 25.2 MB
# + 0.4 MB of scales, ~7.6 us at 3.35 TB/s); the three planes' operations
# at the 60-row prefill (wgu 4096 x 28672: 42 GFLOP, ~0.043 ms at 989
# TFLOP/s, beside ~0.035 ms of weight bytes).

def int8_ln_matmul(x: torch.Tensor, qweight: torch.Tensor,
                   scales: torch.Tensor, ln: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """y[n, dout] = rmsnorm(x[n, din], ln) @ deq(qweight): int8 codes,
    symmetric (no zeros)."""
    if not x.is_cuda:
        return int8_ln_matmul_plain(x, qweight, scales, ln, eps)
    out = _launch_i8(x, qweight, scales, None, ln, eps)
    int8_ln_matmul.launches += 1
    return out


# --------------------------------------------------------------------------
# K7 and K7i4 — replace the mxu_bf16=True mode of gptq_pallas._kernel /
# _kernel_ln (gptq_pallas.py:72-76, 102-110; int8) and of _kernel_int4 /
# _kernel_int4_ln (:157-169, 207-219; packed int4), with the correction
# outside the kernel (:500-526) for packed and asymmetric weights.
# y = bf16(prologue(x)) @ bf16(code * scale) - sum_g xg * (zero + off) *
# scale, f32 accumulation, one rounding: codes as stored (int8, or the
# UNSIGNED nibble with off = 8), xg the group sums of the unrounded f32
# (normed) x. One design for both in csrc/gptq_mma.cu: a per-row pre-pass
# writes the normed rows once (with ln) and the group sums (with a
# correction: zero points, or any packed weight); the main kernel stages
# the bf16 rows and the raw weight bytes in a cp.async ring and converts
# the next slice's weight while the warps run the current slice's mma.sync
# m16n8k16 on bf16 tiles of 128 x 128 outputs (256 x 128 without a
# correction), one barrier a slice; at each group's first k-slice the
# accumulators take that group's rank-1 correction, groups in order. A
# packed k-slice reads 64 byte rows of one nibble plane: a slice never
# straddles din/2. K7i4's block converts on four warps of its own beside
# eight mma warps, so the two overlap in each interval.
# Bound: operations at the pool forward's 480 rows (Llama-3.1-8B wgu
# 4096 x 28672: 113 GFLOP, ~0.11 ms at 989 TFLOP/s, against 118 MB of int8
# or 59 MB of int4 weight, ~0.035 / 0.018 ms).
BF16_MIN_ROWS, BF16_MAX_ROWS = 129, 1024   # the JAX gate (linear.py:270-275)


def _check_bf16_x(x, ln, zeros, din):
    _check(x, "x", (torch.bfloat16, torch.float32))
    if x.data_ptr() % 16:
        raise ValueError("x: must start 16-byte aligned")
    if ln is not None:
        if zeros is not None:
            raise ValueError("the fused norm takes symmetric weights only")
        _check(ln, "ln", (torch.float32,), (din,))


def k7_block_rows(n: int, dout: int, sms: int, zeros: bool = False,
                  packed: bool = False) -> int:
    """K7's and K7i4's output rows per block. K7: 256 (16 warps, one block
    an SM) where 256-row blocks keep at least half the card's SMs busy,
    else 128 (8 warps, two blocks an SM). A 256-row block converts each
    weight slice once for twice the rows; on narrow grids (Llama-3.1-8B wo
    and wdown at 480 rows: 64 such blocks on 132 SMs) 128-row blocks
    measured faster. With zero points, and for K7i4, 128 (one block an SM:
    the correction needs the registers). A function of the shape and the
    card only: every output's sum is the same at either height."""
    blocks = -(-n // 256) * -(-dout // BLOCK_COLS)
    return 256 if not (zeros or packed) and 2 * blocks >= sms else 128


def _k7(x, qweight, scales, zeros, ln, eps, block_rows=None):
    """The C call behind K7 (int8 codes) and K7i4 (packed nibbles)."""
    n, din = x.shape
    dout = qweight.shape[-1]
    packed = qweight.dtype == torch.uint8
    _check_bf16_x(x, ln, zeros, din)
    _weight(qweight, scales, zeros, packed, din, dout)
    dev = x.device
    groups = scales.shape[0]
    bm = block_rows or k7_block_rows(n, dout, _sm_count(dev.index or 0),
                                     zeros is not None, packed)
    x_f32 = x.dtype == torch.float32
    out = torch.empty((n, dout), dtype=x.dtype, device=dev)
    xn = (torch.empty((n, din), dtype=torch.bfloat16, device=dev)
          if ln is not None or x_f32 else None)
    xg = (torch.empty((n, groups), dtype=torch.float32, device=dev)
          if zeros is not None or packed else None)
    lib = _build.lib("gptq_mma")
    err = lib.hsd_k7(
        _ptr(x), int(x_f32), n, din, _ptr(qweight), int(packed), dout, _ptr(scales),
        _bf16(scales), _ptr(zeros), groups, _ptr(ln), float(eps), _ptr(xn),
        _ptr(xg), bm, _ptr(out), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{'K7i4' if packed else 'K7'} (n={n}, din={din}, "
                           f"dout={dout}, ln={ln is not None}, "
                           f"zeros={zeros is not None}, rows a block {bm}): "
                           f"{lib.hsd_mma_error_string(err).decode()}")
    return out


def k7_stage(x: torch.Tensor, ln: torch.Tensor, eps: float,
             groups: Optional[int] = None):
    """K7's and K7i4's pre-pass alone, for its check: (inv [n], xn [n, din]
    bf16), and with `groups` the group sums xg [n, groups] of the unrounded
    normed rows, as k7_stage_plain gives them. The wrappers run it inside
    their own C call; this entry is not on any path and counts no launch."""
    if not x.is_cuda:
        return k7_stage_plain(x, ln, eps, groups)
    n, din = x.shape
    _check_bf16_x(x, ln, None, din)
    inv = torch.empty((n,), dtype=torch.float32, device=x.device)
    xn = torch.empty((n, din), dtype=torch.bfloat16, device=x.device)
    xg = (torch.empty((n, groups), dtype=torch.float32, device=x.device)
          if groups is not None else None)
    lib = _build.lib("gptq_mma")
    err = lib.hsd_k7_stage(_ptr(x), int(x.dtype == torch.float32), n, din,
                           groups or 1, _ptr(ln),
                           float(eps), _ptr(inv), _ptr(xn), _ptr(xg),
                           torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"K7 pre-pass (n={n}, din={din}, groups="
                           f"{groups}): "
                           f"{lib.hsd_mma_error_string(err).decode()}")
    return (inv, xn) if groups is None else (inv, xn, xg)


def int8_matmul_bf16(x: torch.Tensor, qweight: torch.Tensor,
                     scales: torch.Tensor,
                     zeros: Optional[torch.Tensor] = None,
                     ln: Optional[torch.Tensor] = None,
                     eps: float = 0.0) -> torch.Tensor:
    """K7: y[n, dout] = bf16(x or rmsnorm(x, ln)) @ bf16(code * scale) with
    f32 accumulation, less the zero-point correction: int8 codes, bf16
    tensor-core operands. ln takes symmetric weights only. Activations bf16
    or f32 (rounded to bf16 after the norm, as the Pallas mode casts them);
    the output in x's type, an f32 one unrounded."""
    if not x.is_cuda:
        if ln is None:
            return int8_matmul_plain(x, qweight, scales, zeros,
                                     bf16_operands=True)
        if zeros is not None:
            raise ValueError("the fused norm takes symmetric weights only")
        return int8_ln_matmul_plain(x, qweight, scales, ln, eps,
                                    bf16_operands=True)
    out = _k7(x, qweight, scales, zeros, ln, eps)
    int8_matmul_bf16.launches += 1
    return out


def int4_matmul_bf16(x: torch.Tensor, qweight: torch.Tensor,
                     scales: torch.Tensor,
                     zeros: Optional[torch.Tensor] = None,
                     ln: Optional[torch.Tensor] = None,
                     eps: float = 0.0) -> torch.Tensor:
    """K7i4: y[n, dout] = bf16(x or rmsnorm(x, ln)) @ bf16(nibble * scale)
    with f32 accumulation, less the f32 correction sum_g xg * (zero + 8) *
    scale: packed int4 (split-half, unsigned nibbles), bf16 tensor-core
    operands. ln takes symmetric weights only. Activations bf16 or f32, the
    output in x's type, as for K7."""
    if not x.is_cuda:
        if ln is None:
            return int4_matmul_plain(x, qweight, scales, zeros,
                                     bf16_operands=True)
        if zeros is not None:
            raise ValueError("the fused norm takes symmetric weights only")
        return int4_ln_matmul_plain(x, qweight, scales, ln, eps,
                                    bf16_operands=True)
    out = _k7(x, qweight, scales, zeros, ln, eps)
    int4_matmul_bf16.launches += 1
    return out


# --------------------------------------------------------------------------
# Route A's dequantize (`linear.dequant_matmul`, every quantized product of
# more than 128 rows a slot outside the bf16-operand mode): the weight
# dequantized to the activation dtype in one pass, then one torch.matmul.
# Replaces no Pallas kernel: the JAX package dequantizes in XLA code there
# (`dequantize` and `_gptq_matmul_xla`'s `n_rows > 64` branch,
# hsd_tpu/ops/linear.py:124-143, 168-170). csrc/dequant.cu computes the
# plain version's f32 (code - zero) * scale, each step rounded once, and
# rounds once to bf16 or f32: the bits of `dequantize_*_plain(...).to(dtype)`.
# Bound: bytes (packed int4 half a byte in and two out a weight at bf16;
# target wgu 5120 x 27648: 356 MB, 0.106 ms at 3.35 TB/s); a thread owns 8
# columns of 4 code rows, loads their codes first, a group's scales once,
# and stores each output row's 8 values at once (see the source's header).
_DEQUANT_DTYPES = (torch.bfloat16, torch.float32)


def _check_rows(t: torch.Tensor, name: str, dtypes, shape, device):
    """A 2-D CUDA tensor on `device` whose output dimension (the last) is
    contiguous; its rows may lie apart (a view of a stacked weight)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.stride(1) != 1:
        raise ValueError(f"{name}: the output dimension must be contiguous "
                         f"(strides {t.stride()})")


def _dequant(qweight, scales, zeros, dtype, packed: bool) -> torch.Tensor:
    """The C call behind both dequantize wrappers."""
    if dtype not in _DEQUANT_DTYPES:
        raise ValueError(f"dequantize: output dtype {dtype} not in "
                         f"{_DEQUANT_DTYPES}")
    dev = qweight.device
    if qweight.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"dequantize: 2-D qweight and scales, got "
                         f"{tuple(qweight.shape)}, {tuple(scales.shape)}")
    rows, dout = qweight.shape
    groups = scales.shape[0]
    _check_rows(qweight, "qweight", (torch.uint8,) if packed
                else (torch.int8,), (rows, dout), dev)
    _check_rows(scales, "scales", _ACT, (groups, dout), dev)
    if zeros is not None:
        _check_rows(zeros, "zeros", (torch.float32,), (groups, dout), dev)
    din = 2 * rows if packed else rows
    if din % groups:
        raise ValueError(f"dequantize: {din} input rows in {groups} groups")
    out = torch.empty((din, dout), dtype=dtype, device=dev)
    lib = _build.lib("dequant")
    err = lib.hsd_dequant(
        _ptr(qweight), int(packed), qweight.stride(0), rows, dout,
        _ptr(scales), _bf16(scales), scales.stride(0), groups, _ptr(zeros),
        0 if zeros is None else zeros.stride(0), _ptr(out),
        int(dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{'int4' if packed else 'int8'} dequantize "
                           f"(din={din}, dout={dout}, groups={groups}, "
                           f"zeros={zeros is not None}): "
                           f"{lib.hsd_dequant_error_string(err).decode()}")
    return out


def dequantize_int4(qweight: torch.Tensor, scales: torch.Tensor,
                    zeros: Optional[torch.Tensor] = None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Packed int4 [din/2, dout] -> [din, dout] weight in `dtype` (bf16 or
    f32 on the card): (nibble - 8 - zero) * scale in f32, rounded once to
    dtype; split-half rows."""
    if not qweight.is_cuda:
        return dequantize_int4_plain(qweight, scales, zeros).to(dtype)
    out = _dequant(qweight, scales, zeros, dtype, packed=True)
    dequantize_int4.launches += 1
    return out


def dequantize_int8(qweight: torch.Tensor, scales: torch.Tensor,
                    zeros: Optional[torch.Tensor] = None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 codes [din, dout] -> [din, dout] weight in `dtype` (bf16 or f32
    on the card): (code - zero) * scale in f32, rounded once to dtype."""
    if not qweight.is_cuda:
        return dequantize_int8_plain(qweight, scales, zeros).to(dtype)
    out = _dequant(qweight, scales, zeros, dtype, packed=False)
    dequantize_int8.launches += 1
    return out


WRAPPERS = {"K1": int4_ln_matmul, "K2": attn_mlp_int4, "K3": int4_matmul,
            "K4": int8_matmul, "K5": int8_ln_matmul, "K6": mlp_int4,
            "K7": int8_matmul_bf16, "K7i4": int4_matmul_bf16,
            "dequantize_int4": dequantize_int4,
            "dequantize_int8": dequantize_int8}
for _w in WRAPPERS.values():
    _w.launches = 0
