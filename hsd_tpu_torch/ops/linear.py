"""Linear layers: dense or GPTQ weight-only quantized.

The port of `hsd_tpu/ops/linear.py`. A quantized weight is a
`QuantizedLinear` of int8 or packed-int4 codes with per-group scales and
optional zero points; it drops into the same `apply_linear` call sites as a
dense tensor. On a CUDA tensor every quantized matmul runs a hand-written
kernel (`ops/gptq_cuda.py`); on a CPU tensor the kernel's plain version.
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
    A layer-stacked weight carries a leading [L] axis on every field.
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
        """Layer `idx` of a stacked weight (views, no copy)."""
        return QuantizedLinear(
            qweight=self.qweight[idx], scales=self.scales[idx],
            zeros=None if self.zeros is None else self.zeros[idx],
            perm=(self.perm[idx] if self.perm is not None
                  and self.perm.dim() == 2 else self.perm))


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


def apply_linear(w, x: torch.Tensor, b: Optional[torch.Tensor] = None,
                 layer: Optional[int] = None, norm=None,
                 mxu_bf16: bool = False) -> torch.Tensor:
    """y = x @ w (+ b) for dense tensors or QuantizedLinear weights.

    layer: select this layer of a LAYER-STACKED weight ([L, in, out]).
    norm: optional (norm_weight [in], eps): y = rmsnorm(x) @ w. For a
    SYMMETRIC weight the norm is fused into the kernel's activation read
    and stays f32 (K1 packed int4, K5 int8); every other weight norms first
    and rounds to the activation dtype, as the JAX package does
    (`linear.py:277-279`).
    mxu_bf16: bf16 operands with f32 accumulation (`ModelConfig.
    gptq_mxu_bf16`), taken as the JAX gate does (`linear.py:270-276`): only
    at 129-1024 rows, and here for symmetric int8 weights (K7). The JAX gate
    also asks `batched_rows_ok`, which checks that a 128-wide out-block of
    the Pallas kernel fits the TPU's VMEM budget beside the wide activation
    tile; it is true at every int8 shape of this path and says nothing
    about the card, so the port drops it. Packed-int4 and asymmetric
    weights keep their f32 kernels. K7 takes bf16 activations only: an
    f32 model with the flag raises on the card.
    """
    ln, eps = norm if norm is not None else (None, 0.0)
    if isinstance(w, QuantizedLinear):
        if layer is not None and w.qweight.dim() == 3:
            w = w.layer(layer)
        if w.perm is not None:
            if ln is not None:          # the norm is feature-order-sensitive
                x = rms_norm(x, ln, eps)
                ln = None
            x = x.index_select(-1, w.perm.long())
            w = w._replace(perm=None)
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        sym = w.zeros is None
        bf16_rows = (gptq_cuda.BF16_MIN_ROWS <= x2.shape[0]
                     <= gptq_cuda.BF16_MAX_ROWS)
        if mxu_bf16 and bf16_rows and sym and not w.packed_int4:
            y = gptq_cuda.int8_matmul_bf16(x2, w.qweight, w.scales, ln, eps)
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
              layer: Optional[int] = None,
              mxu_bf16: bool = False) -> torch.Tensor:
    """SwiGLU MLP: (silu(g) * u) @ wdown with [g | u] = rmsnorm(x) @ wgu,
    without the residual add, as two apply_linear calls. (The JAX package's
    one-kernel MLP, `gptq_mlp_int4`, is not ported yet.)"""
    f = wdown.din if isinstance(wdown, QuantizedLinear) else wdown.shape[-2]
    gu = apply_linear(wgu, x, layer=layer, norm=(ln_w, eps),
                      mxu_bf16=mxu_bf16)
    ff = F.silu(gu[..., :f]) * gu[..., f:]
    return apply_linear(wdown, ff, layer=layer, mxu_bf16=mxu_bf16)


def attn_mlp_fusable(att: torch.Tensor, wo, wgu, wdown) -> bool:
    """Can the layer tail (wo + residual + SwiGLU MLP + residual) run as the
    fused K2? All three packed int4, symmetric, without perm, with matching
    shapes, at decode and verify row counts (the JAX gate's ≤ 32 rows)."""
    ws = (wo, wgu, wdown)
    if not all(isinstance(w, QuantizedLinear) for w in ws):
        return False
    if not all(w.packed_int4 and w.zeros is None and w.perm is None
               for w in ws):
        return False
    if len({w.qweight.dim() for w in ws}) != 1:
        return False
    d = wo.qweight.shape[-1]
    shapes_ok = (att.shape[-1] == wo.din and wgu.din == d
                 and wgu.qweight.shape[-1] == 2 * wdown.din
                 and wdown.qweight.shape[-1] == d)
    n_rows = att.numel() // att.shape[-1]
    return shapes_ok and n_rows <= gptq_cuda.TAIL_MAX_ROWS


def apply_attn_mlp(att: torch.Tensor, x: torch.Tensor, wo, wgu, wdown,
                   ln_w: torch.Tensor, eps: float,
                   layer: Optional[int] = None) -> torch.Tensor:
    """The fused layer tail (K2): returns x' + mlp(rmsnorm(x')) with
    x' = x + att @ wo kept in f32. Gate with attn_mlp_fusable."""
    if layer is not None and wo.qweight.dim() == 3:
        wo, wgu, wdown = wo.layer(layer), wgu.layer(layer), wdown.layer(layer)
    lead = x.shape[:-1]
    out = gptq_cuda.attn_mlp_int4(
        att.reshape(-1, att.shape[-1]).contiguous(),
        x.reshape(-1, x.shape[-1]).contiguous(),
        wo.qweight, wo.scales, wgu.qweight, wgu.scales, wdown.qweight,
        wdown.scales, ln_w, eps)
    return out.reshape(*lead, out.shape[-1])
