"""Linear layers: dense or GPTQ weight-only quantized.

The port of `hsd_tpu/ops/linear.py`. A quantized weight is a
`QuantizedLinear` of int8 or packed-int4 codes with per-group scales and
optional zero points; it drops into the same `apply_linear` call sites as a
dense tensor. A quantized matmul takes a hand-written kernel
(`ops/gptq_cuda.py`; on a CPU tensor the kernel's plain version) where the
JAX package takes its Pallas kernel on its device (`kernel_route`), and
every other product the reference's XLA route in plain PyTorch
(`xla_matmul`: grouped f32 partial sums up to 64 rows, dequantize-then-dot
above).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import gptq_cuda


class QuantizedLinear(NamedTuple):
    """GPTQ-style weight-only quantization of a [in, out] matmul.

    qweight: [in, out] int8 codes, OR [in/2, out] uint8 nibble-packed int4
             (the uint8 dtype is the 4-bit marker). The packing is
             SPLIT-HALF, as `pack_int4` writes it: the low nibble of byte
             row i holds input row i, the high nibble input row i + in/2,
             each stored as code + 8.
    scales:  [groups, out]; group g covers input rows [g*gs, (g+1)*gs)
    zeros:   [groups, out] float zero points (asymmetric) or None
    perm:    [in] input permutation (desc_act checkpoints) or None;
             apply_linear gathers x[..., perm] before the matmul.
    A layer-stacked weight carries a leading [L] axis on every field, an
    MoE expert stack [L, E]; perm carries them too, or is one [in] shared
    by every layer.
    """

    qweight: torch.Tensor
    scales: torch.Tensor
    zeros: Optional[torch.Tensor]
    perm: Optional[torch.Tensor] = None

    @property
    def packed_int4(self) -> bool:
        return self.qweight.dtype == torch.uint8

    @property
    def din(self) -> int:
        n = self.qweight.shape[-2]
        return 2 * n if self.packed_int4 else n

    def layer(self, idx: int) -> "QuantizedLinear":
        """Entry `idx` of the leading axis of a stacked weight (views, no
        copy): a layer of [L, ...], or an expert of [E, ...], so expert e
        of layer l of an [L, E, ...] stack is `w.layer(l).layer(e)`. perm
        is sliced where it carries qweight's leading axes."""
        stacked_perm = (self.perm is not None
                        and self.perm.dim() == self.qweight.dim() - 1)
        return QuantizedLinear(
            qweight=self.qweight[idx], scales=self.scales[idx],
            zeros=None if self.zeros is None else self.zeros[idx],
            perm=self.perm[idx] if stacked_perm else self.perm)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Signed int4 codes [in, out] (values in [-8, 7]) -> uint8 [in/2, out],
    split-half: low nibble = row i, high nibble = row i + in/2, stored
    unsigned as code + 8."""
    din = codes.shape[0]
    if din % 2:
        raise ValueError(f"pack_int4 needs an even row count, got {din}")
    half = din // 2
    lo = (codes[:half].to(torch.int32) + 8) & 0xF
    hi = (codes[half:].to(torch.int32) + 8) & 0xF
    return ((hi << 4) | lo).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4: uint8 [in/2, out] -> int8 codes [in, out]."""
    b = packed.to(torch.int32)
    return torch.cat([(b & 0xF) - 8, (b >> 4) - 8], dim=0).to(torch.int8)


def quantize(w: torch.Tensor, bits: int = 8, group_size: int = 128,
             symmetric: bool = False) -> QuantizedLinear:
    """Round-to-nearest (half to even) GPTQ-style quantization of a dense
    [in, out] weight, bit for bit as the JAX package computes it."""
    din, dout = w.shape
    if din % group_size:
        raise ValueError(f"in-features {din} not divisible by {group_size}")
    g = din // group_size
    wf = w.float().reshape(g, group_size, dout)
    qmax = (1 << (bits - 1)) - 1
    if symmetric:
        scale = torch.amax(wf.abs(), dim=1) / qmax
        scale = torch.clamp(scale, min=1e-8)
        codes = torch.clamp(torch.round(wf / scale[:, None, :]), -qmax - 1, qmax)
        zeros = None
    else:
        lo = torch.amin(wf, dim=1)
        hi = torch.amax(wf, dim=1)
        scale = torch.clamp((hi - lo) / (2 * qmax + 1), min=1e-8)
        zero = lo / scale + qmax + 1
        codes = torch.clamp(torch.round(wf / scale[:, None, :] - zero[:, None, :]),
                            -qmax - 1, qmax)
        zeros = (-zero).float()
    codes = codes.reshape(din, dout).to(torch.int8)
    if bits == 4 and din % 2 == 0:
        codes = pack_int4(codes)
    return QuantizedLinear(qweight=codes, scales=scale.float(), zeros=zeros)


def dequantize(qw: QuantizedLinear, dtype=torch.bfloat16) -> torch.Tensor:
    """w[i, o] = (code - zero[g(i), o]) * scale; for a desc_act weight the
    rows come back in ORIGINAL input order."""
    if qw.packed_int4:
        w = gptq_cuda.dequantize_int4(qw.qweight, qw.scales, qw.zeros)
    else:
        w = gptq_cuda.dequantize_int8(qw.qweight, qw.scales, qw.zeros)
    if qw.perm is not None:
        w = torch.zeros_like(w).index_copy_(0, qw.perm.long(), w)
    return w.to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, rounded back to the activation dtype (`_rms_xla`)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


# The bf16-operand gate. The JAX auto route runs bf16 operands at 129-1024
# rows where its Pallas kernel takes the shape (`pallas_supported`,
# gptq_pallas.py:1117) and a block plan exists beside the wide activation
# tile (`batched_rows_ok`, :1097), and f32 elsewhere; the two round
# differently, so the port keeps both decisions, as shape checks. The v5e
# budgets below only decide WHETHER bf16 operands apply; the block sizes
# they pick are not ported.
_MIB = 1024 * 1024
MAX_PACKED_ROWS = 3584          # one in-block of a packed-int4 weight


def _pick_block_in_packed(rows: int, gs: int) -> int:
    """`_pick_block_in_packed`: all packed rows when they fit
    MAX_PACKED_ROWS, else the largest multiple of gs that divides them."""
    if rows <= MAX_PACKED_ROWS:
        return rows
    for d in range(MAX_PACKED_ROWS // gs, 0, -1):
        if rows % (d * gs) == 0:
            return d * gs
    return rows


def _pick_block_in(din: int, gs: int, target: int = 8192) -> int:
    """`_pick_block_in` (int8): all of din when it fits the target, else the
    largest divisor whose group count is a multiple of 8."""
    if din <= target:
        return din
    n_groups = din // gs
    best = din
    for d in range(1, n_groups + 1):
        if n_groups % d == 0 and d % 8 == 0 and d * gs <= target:
            best = d * gs
    return best


def pallas_supported(w: QuantizedLinear) -> bool:
    """The Pallas kernel takes the weight's shape: packed int4 with an even
    group count, groups a multiple of 64 rows and out-width of 128; int8
    with groups a multiple of 128 rows and out-width of 128."""
    rows, dout = w.qweight.shape[-2:]
    groups = w.scales.shape[-2]
    if w.packed_int4:
        gs = 2 * rows // groups
        return not (2 * rows % gs or gs % 64 or dout % 128 or groups % 2)
    if w.qweight.dtype != torch.int8:
        return False
    gs = rows // groups
    return not (rows % gs or gs % 128 or dout % 128)


def batched_rows_ok(w: QuantizedLinear, n: int) -> bool:
    """A legal (>= 128-wide) out-block survives beside n rows of wide f32
    activations under the kernel's VMEM budget (`_out_block_limit` with
    `raw=True` and the auto in-block)."""
    rows = w.qweight.shape[-2]
    npad = max(8, -(-n // 8) * 8)
    if w.packed_int4:
        gs = 2 * rows // w.scales.shape[-2]
        block_in = _pick_block_in_packed(rows, gs)
        limit = 48 * _MIB // (14 * block_in + 16 * npad)
    else:
        gs = rows // w.scales.shape[-2]
        block_in = _pick_block_in(rows, gs)
        limit = ((24 * _MIB - 4 * npad * block_in)
                 // (2 * block_in + 16 * npad))
        limit = min(limit, 8 * _MIB // block_in)
    return limit >= 128


def bf16_route(w: QuantizedLinear, n: int, mxu_bf16: bool) -> bool:
    """Does an n-row product with `w` take bf16 operands (K7 / K7i4)?"""
    return (mxu_bf16
            and gptq_cuda.BF16_MIN_ROWS <= n <= gptq_cuda.BF16_MAX_ROWS
            and pallas_supported(w) and batched_rows_ok(w, n))


KERNEL_MAX_ROWS = 128      # the JAX gate's decode regime (linear.py:221-223)


def kernel_route(w: QuantizedLinear, n: int, mxu_bf16: bool) -> bool:
    """Does an n-row product with `w` take a kernel? The port's form of the
    JAX package's on-device rule (`_use_pallas`, linear.py:193-225): the
    Pallas kernel takes the shape, and the call has at most 128 rows or
    takes the bf16 operands. apply_linear sends every other call, at any
    row count, to `xla_matmul`, as the reference sends it to
    `_gptq_matmul_xla`."""
    return pallas_supported(w) and (n <= KERNEL_MAX_ROWS
                                    or bf16_route(w, n, mxu_bf16))


def dequant_matmul(x: torch.Tensor, w: QuantizedLinear) -> torch.Tensor:
    """x @ dequantize(w, x.dtype) as one torch.matmul: the JAX package's
    route for products of more than 64 rows that its kernel does not take
    (the `n_rows > 64` branch of `_gptq_matmul_xla`, linear.py:124-143,
    168-170; `xla_matmul` below): the weight rounds to the activation dtype, as
    bf16((code - zero) * scale) in a bf16 model, and the dot accumulates in
    f32. XLA code in the reference, so plain PyTorch here, not a kernel: no
    launch counter. cuBLAS picks its algorithm by shape, so a row's bits
    may depend on the row count, as the reference's do. An f32 product runs
    in f32: TF32 must be off (checked here, not set)."""
    if x.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("dequant_matmul: an f32 product needs "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    return torch.matmul(x, dequantize(w, x.dtype))


XLA_PARTIAL_MAX_ROWS = 64  # _gptq_matmul_xla's grouped-partials regime


def xla_matmul(x: torch.Tensor, w: QuantizedLinear) -> torch.Tensor:
    """x[n, din] @ w as the JAX package's XLA route computes it
    (`_gptq_matmul_xla`, linear.py:146-182), for every call that takes no
    kernel. Above 64 rows, `dequant_matmul`. At most 64 rows, the grouped
    partial sums: part[n, g, dout] = x_g @ codes_g with the codes (packed
    int4 unpacked to signed codes) in the activation dtype, which is exact,
    accumulated in f32; times the f32 scales, less xsum_g * zero * scale
    with zero points, summed over the groups and rounded once to x's dtype.
    XLA code in the reference, so plain PyTorch here, not a kernel: no
    launch counter. The f32 dot needs TF32 off (checked, not set)."""
    n = x.shape[0]
    if n > XLA_PARTIAL_MAX_ROWS:
        return dequant_matmul(x, w)
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("xla_matmul: the f32 partial sums need "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    codes = unpack_int4(w.qweight) if w.packed_int4 else w.qweight
    din, dout = codes.shape
    g = w.scales.shape[0]
    # x_g in x's dtype, then f32: the products of the dtype's values, summed
    # in f32 (preferred_element_type=f32)
    xg = x.reshape(n, g, din // g).float()
    c = codes.to(x.dtype).float().reshape(g, din // g, dout)
    part = torch.bmm(xg.transpose(0, 1), c).transpose(0, 1)    # [n, g, dout]
    scales = w.scales.float()
    part = part * scales[None]
    if w.zeros is not None:
        xsum = xg.sum(-1)                                      # [n, g]
        part = part - xsum[:, :, None] * (w.zeros.float() * scales)[None]
    return part.sum(1).to(x.dtype)


def route_rows(n: int, slots: int) -> int:
    """The row count a route decision sees: one slot's rows. A pool's call
    stacks `slots` slots of equal rows; the JAX package maps its per-slot
    forward over the slots, so its gates count one slot's rows, and so do
    the port's. The kernel then runs every row at once: a row's bits do
    not depend on the row count."""
    if n % slots:
        raise ValueError(f"{n} rows do not split into {slots} slots")
    return n // slots


def apply_linear(w, x: torch.Tensor, b: Optional[torch.Tensor] = None,
                 layer: Optional[int] = None, norm=None,
                 mxu_bf16: bool = False, slots: int = 1) -> torch.Tensor:
    """y = x @ w (+ b) for dense tensors or QuantizedLinear weights.

    layer: select this layer of a LAYER-STACKED weight ([L, in, out]).
    A quantized weight must then be one [in, out] matrix: an expert of an
    MoE stack is selected by the caller (`QuantizedLinear.layer`), so each
    expert's product routes on its own rows, as the JAX package's vmap
    over the experts routes them.
    norm: optional (norm_weight [in], eps): y = rmsnorm(x) @ w. On a
    kernel route with a SYMMETRIC weight the norm is fused into the
    kernel's activation read and stays f32 (K1 packed int4, K5 int8);
    everywhere else it norms first and rounds to the activation dtype, as
    the JAX package does (`linear.py:277-279`).
    Routes, as the JAX package's on its device (`kernel_route`): where the
    Pallas kernel takes the shape, at most 128 rows the f32-operand kernels
    (K1, K3, K4, K5) and 129-1024 rows with mxu_bf16 the bf16-operand ones
    (below); every other product, at any row count, `xla_matmul` (the norm
    first, rounded, then the reference's XLA arithmetic). No call falls
    from a kernel to that route.
    mxu_bf16: bf16 operands with f32 accumulation (`ModelConfig.
    gptq_mxu_bf16`), taken where the JAX auto route takes them on its
    device (`linear.py:270-276, 221-225`): 129-1024 rows and the Pallas
    shape gates (`bf16_route`). Every int8 or packed-int4 weight then runs
    the tensor-core template, K7 (int8) or K7i4 (packed int4), with the
    zero-point / -8 correction in f32; the norm fuses for symmetric weights
    only (an asymmetric one norms first and rounds to the activation
    dtype). The kernels take bf16 activations only: an f32 model with the
    flag raises on the card.
    slots: x's rows are that many slots of equal rows; the routes are
    decided on one slot's rows (`route_rows`).
    """
    ln, eps = norm if norm is not None else (None, 0.0)
    if isinstance(w, QuantizedLinear):
        if layer is not None and w.qweight.dim() == 3:
            w = w.layer(layer)
        if w.qweight.dim() != 2:
            raise ValueError(f"apply_linear takes one [in, out] weight, got "
                             f"qweight {tuple(w.qweight.shape)}")
        if w.perm is not None:
            if ln is not None:          # the norm is feature-order-sensitive
                x = rms_norm(x, ln, eps)
                ln = None
            x = x.index_select(-1, w.perm.long())
            w = w._replace(perm=None)
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        n = route_rows(x2.shape[0], slots)
        sym = w.zeros is None
        if not kernel_route(w, n, mxu_bf16):
            if ln is not None:
                x2 = rms_norm(x2, ln, eps)
            y = xla_matmul(x2, w)
        elif bf16_route(w, n, mxu_bf16):
            if ln is not None and not sym:
                x2 = rms_norm(x2, ln, eps)
                ln = None
            kern = (gptq_cuda.int4_matmul_bf16 if w.packed_int4
                    else gptq_cuda.int8_matmul_bf16)
            y = kern(x2, w.qweight, w.scales, w.zeros, ln, eps)
        elif ln is not None and sym:
            fused = (gptq_cuda.int4_ln_matmul if w.packed_int4
                     else gptq_cuda.int8_ln_matmul)
            y = fused(x2, w.qweight, w.scales, ln, eps)
        else:
            if ln is not None:
                x2 = rms_norm(x2, ln, eps)
            if w.packed_int4:
                y = gptq_cuda.int4_matmul(x2, w.qweight, w.scales, w.zeros)
            else:
                y = gptq_cuda.int8_matmul(x2, w.qweight, w.scales, w.zeros)
        y = y.reshape(*lead, y.shape[-1])
    else:
        if ln is not None:
            x = rms_norm(x, ln, eps)
        if layer is not None:
            w = w[layer]
        y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def apply_mlp(wgu, wdown, x: torch.Tensor, ln_w: torch.Tensor, eps: float,
              layer: Optional[int] = None, mxu_bf16: bool = False,
              slots: int = 1) -> torch.Tensor:
    """SwiGLU MLP: (silu(g) * u) @ wdown with [g | u] = rmsnorm(x) @ wgu,
    without the residual add. Where `mlp_fusable` holds, one fused call (K6,
    `gu` and `silu(g) * u` kept in f32, as `gptq_mlp_int4`); elsewhere two
    apply_linear calls. slots: as apply_linear's."""
    if mlp_fusable(x, wgu, wdown, layer, slots):
        if layer is not None:
            wgu, wdown = wgu.layer(layer), wdown.layer(layer)
        out = gptq_cuda.mlp_int4(x.reshape(-1, x.shape[-1]).contiguous(),
                                 wgu.qweight, wgu.scales, wdown.qweight,
                                 wdown.scales, ln_w, eps)
        return out.reshape(*x.shape[:-1], out.shape[-1])
    f = wdown.din if isinstance(wdown, QuantizedLinear) else wdown.shape[-2]
    gu = apply_linear(wgu, x, layer=layer, norm=(ln_w, eps),
                      mxu_bf16=mxu_bf16, slots=slots)
    ff = F.silu(gu[..., :f]) * gu[..., f:]
    return apply_linear(wdown, ff, layer=layer, mxu_bf16=mxu_bf16,
                        slots=slots)


# Fusion gates. The JAX package fuses the MLP (K6) and the layer tail (K2)
# only where its Pallas block plan exists (gptq_pallas._mlp_blocks,
# _attn_mlp_blocks), and a fused route rounds differently from the unfused
# one, so the port keeps every condition of that plan which decides WHETHER
# to fuse; the block sizes it picks are not ported.
_MLP_GU_BUDGET, _MLP_DOWN_BUDGET = 36 * _MIB, 52 * _MIB
_AM_WO_BUDGET, _AM_GU_BUDGET, _AM_DOWN_BUDGET = 24 * _MIB, 37 * _MIB, 52 * _MIB


def _out_block_fits(dout: int, budget: int, rows: int, npad: int) -> bool:
    """`_divisor_block(dout, budget // (14 * rows + 16 * npad))` is nonzero:
    a 128-multiple divisor of dout fits the budget's per-column limit."""
    return dout % 128 == 0 and dout >= 128 and \
        budget // (14 * rows + 16 * npad) >= 128


def _int4_sym(*ws) -> bool:
    return all(isinstance(w, QuantizedLinear) and w.packed_int4
               and w.zeros is None and w.perm is None for w in ws)


def _stacked_ok(layer, *ws) -> bool:
    """The JAX route's `stacked_ok`: the weights are all layer-stacked with
    a layer index given, or all 2-D without one."""
    ndims = {w.qweight.dim() for w in ws}
    return len(ndims) == 1 and (layer is not None) == (ndims.pop() == 3)


def _mlp_plan(wgu, wdown, npad: int):
    """`_mlp_blocks`' decision: the wdown in-block when the fused MLP has a
    block plan for `npad` padded rows, else None."""
    if not _int4_sym(wgu, wdown):
        return None
    Rg, GU = wgu.qweight.shape[-2:]
    Rd, D = wdown.qweight.shape[-2:]
    gg, gd = wgu.scales.shape[-2], wdown.scales.shape[-2]
    if GU != 4 * Rd or gg % 2 or gd % 2:
        return None
    gs_g, gs_d = (2 * Rg) // gg, (2 * Rd) // gd
    if gs_g % 64 or gs_d % 64 or GU % 128 or D % 128 or Rg % gs_g:
        return None
    if Rg > MAX_PACKED_ROWS:
        return None
    bid = _pick_block_in_packed(Rd, gs_d)
    if Rd % bid or bid % gs_d:
        return None
    if not (_out_block_fits(GU, _MLP_GU_BUDGET, Rg, npad)
            and _out_block_fits(D, _MLP_DOWN_BUDGET, bid, npad)):
        return None
    return bid


def _rows(x: torch.Tensor, slots: int = 1):
    """(rows, padded rows) of one slot's activation, as the JAX gates count
    them."""
    n = route_rows(x.numel() // x.shape[-1], slots)
    return n, max(8, -(-n // 8) * 8)


def mlp_fusable(x: torch.Tensor, wgu, wdown,
                layer: Optional[int] = None, slots: int = 1) -> bool:
    """Can the SwiGLU MLP of `layer` (None: 2-D weights) run as the fused
    K6? The JAX route's conditions (`linear.apply_mlp`'s `stacked_ok`, then
    `mlp_fusion_supported`): both packed int4, symmetric, no perm, stacked
    alike and indexed so, at most TAIL_MAX_ROWS rows and a block plan; plus
    the shapes the JAX gate leaves unchecked (x's width). Rows are counted
    per slot (`route_rows`)."""
    if not (_int4_sym(wgu, wdown) and _stacked_ok(layer, wgu, wdown)):
        return False
    n, npad = _rows(x, slots)
    shapes_ok = (x.shape[-1] == wgu.din
                 and wgu.qweight.shape[-1] == 2 * wdown.din)
    return (shapes_ok and n <= gptq_cuda.TAIL_MAX_ROWS
            and _mlp_plan(wgu, wdown, npad) is not None)


def attn_mlp_fusable(att: torch.Tensor, wo, wgu, wdown,
                     layer: Optional[int] = None, slots: int = 1) -> bool:
    """Can the layer tail (wo + residual + SwiGLU MLP + residual) of
    `layer` (None: 2-D weights) run as the fused K2? The JAX route's
    conditions (`linear.attn_mlp_fusable`'s `stacked_ok`, then
    `attn_mlp_fusion_supported`): all three packed int4, symmetric, no perm,
    stacked alike and indexed so, at most TAIL_MAX_ROWS rows, the MLP's
    block plan, wo's out-width equal to the MLP's in-width, even wo groups
    of a multiple of 64, at most MAX_PACKED_ROWS packed wo rows, and every
    phase's out-block under its budget; plus the shapes the JAX gate leaves
    unchecked (wdown's out-width). Rows are counted per slot
    (`route_rows`)."""
    if not (_int4_sym(wo, wgu, wdown) and _stacked_ok(layer, wo, wgu, wdown)):
        return False
    n, npad = _rows(att, slots)
    Rw, D = wo.qweight.shape[-2:]
    Rg, GU = wgu.qweight.shape[-2:]
    shapes_ok = (att.shape[-1] == wo.din and wgu.din == D
                 and GU == 2 * wdown.din and wdown.qweight.shape[-1] == D)
    if not shapes_ok or n > gptq_cuda.TAIL_MAX_ROWS:
        return False
    bid = _mlp_plan(wgu, wdown, npad)
    if bid is None:
        return False
    gw = wo.scales.shape[-2]
    if gw % 2:
        return False
    gs_w = (2 * Rw) // gw
    if gs_w % 64 or Rw % gs_w or Rw > MAX_PACKED_ROWS:
        return False
    return (_out_block_fits(D, _AM_WO_BUDGET, Rw, npad)
            and _out_block_fits(GU, _AM_GU_BUDGET, Rg, npad)
            and _out_block_fits(D, _AM_DOWN_BUDGET, bid, npad))


def apply_attn_mlp(att: torch.Tensor, x: torch.Tensor, wo, wgu, wdown,
                   ln_w: torch.Tensor, eps: float,
                   layer: Optional[int] = None) -> torch.Tensor:
    """The fused layer tail (K2): returns x' + mlp(rmsnorm(x')) with
    x' = x + att @ wo kept in f32. Gate with attn_mlp_fusable."""
    if layer is not None:
        wo, wgu, wdown = wo.layer(layer), wgu.layer(layer), wdown.layer(layer)
    lead = x.shape[:-1]
    out = gptq_cuda.attn_mlp_int4(
        att.reshape(-1, att.shape[-1]).contiguous(),
        x.reshape(-1, x.shape[-1]).contiguous(),
        wo.qweight, wo.scales, wgu.qweight, wgu.scales, wdown.qweight,
        wdown.scales, ln_w, eps)
    return out.reshape(*lead, out.shape[-1])
