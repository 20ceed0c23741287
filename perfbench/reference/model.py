"""The plain reference of the served decoders: Qwen2-style dense and
Mixtral-style sparse-MoE layers in float32, from the raw codes and scales
that the benchmark made (`harness/weights.py`), with no kernel, no cache
and no batching trick.

A model is a dict of raw tensors (see `harness/weights.py`); its shapes are
a dict of the configuration's sizes (`hidden_size`, `num_hidden_layers`,
`num_attention_heads`, `num_key_value_heads`, `head_dim` where it is not
hidden_size over the heads, `rope_theta`, `rms_norm_eps`,
`num_local_experts` / `num_experts_per_tok` for MoE). The head is tied to
the embedding, packed int4, or a dense [D, V] matrix of its own.
Packed int4 is split-half (the low nibble of byte row i is input row i,
the high nibble row i + in/2, each stored as code + 8); int8 codes are
signed; a weight is (code - zero) * scale per group of input rows.

`logits(...)` runs whole sequences from position 0 (RoPE positions 0, 1,
...), causal attention, and applies the final norm and the head only at
the positions asked for. The weights are dequantized one layer at a time,
so the float32 copy of a 14B or Mixtral layer is the largest buffer.

`precision="fp8"` is the control: every product's operands are rounded to
float8 e4m3 (activations with a scale a row, weights a scale an output
column) before a float32 product; attention, norms and softmax stay
float32. It imports neither jax nor the program.

A configuration whose block this file does not compute brings its own
reference, a file beside this one with a `logits` of the same signature,
named by the configuration's `.py` (`harness/coupled.Served.reference`).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t rounded to e4m3 with one scale along `dim`'s complement (a scale
    a row for dim=-1)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    s = amax / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [in/2, out] split-half -> float32 signed codes [in, out]."""
    b = packed.to(torch.int16)
    return torch.cat([(b & 0xF) - 8, (b >> 4) - 8], dim=0).float()


def dequant(w: dict) -> torch.Tensor:
    """A raw quantized matrix {"codes", "scales", "zeros", "bits"} (one
    [in, out] matrix) -> float32 [in, out]."""
    codes = unpack_int4(w["codes"]) if w["bits"] == 4 else w["codes"].float()
    din, dout = codes.shape
    g = w["scales"].shape[0]
    c = codes.reshape(g, din // g, dout)
    if w.get("zeros") is not None:
        c = c - w["zeros"].float()[:, None, :]
    return (c * w["scales"].float()[:, None, :]).reshape(din, dout)


def _mat(w, idx) -> torch.Tensor:
    """Entry idx of a stacked weight (raw quantized dict or dense tensor),
    as float32."""
    if isinstance(w, dict):
        return dequant({"codes": w["codes"][idx], "scales": w["scales"][idx],
                        "zeros": None if w.get("zeros") is None
                        else w["zeros"][idx], "bits": w["bits"]})
    return w[idx].float()


def _lin(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """NeoX rotate-half at positions 0..T-1. x: [T, H, d]."""
    T, _, d = x.shape
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                          device=x.device) / d))
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _embed(model: dict, ids: torch.Tensor) -> torch.Tensor:
    e = model["embed"]
    if isinstance(e, dict):                       # int8 codes, a scale a row
        return e["codes"][ids].float() * e["scale"][ids].float()[:, None]
    return e[ids].float()


def _head(model: dict) -> torch.Tensor:
    h = model.get("lm_head")
    if h is None:                                  # tied to the embedding
        return model["embed"].float().t()
    if isinstance(h, dict):                        # quantized
        return dequant(h)
    return h.float()                               # dense [D, V], untied


def _attention(q, k, v) -> torch.Tensor:
    """Causal GQA attention of one sequence. q [T, H, d], k / v [T, Hkv, d]."""
    T, H, d = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("thd,shd->hts", q, k) * d ** -0.5
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    return torch.einsum("hts,shd->thd", torch.softmax(s, -1), v)


def _moe(shape: dict, layers: dict, l: int, h: torch.Tensor,
         precision: str) -> torch.Tensor:
    """Top-k routed SwiGLU experts: softmax over the router's logits, the
    k largest renormalized; only the routed rows run through an expert."""
    E, k = shape["num_local_experts"], shape["num_experts_per_tok"]
    probs = torch.softmax(h @ layers["gate"][l].float(), -1)
    top_w, top_i = torch.topk(probs, k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(E):
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        g = _lin(x, _mat(layers["wgate"], (l, e)), precision)
        u = _lin(x, _mat(layers["wup"], (l, e)), precision)
        y = _lin(F.silu(g) * u, _mat(layers["wdown"], (l, e)), precision)
        out.index_add_(0, rows, top_w[rows, slot][:, None] * y)
    return out


@torch.no_grad()
def logits(shape: dict, model: dict, seqs: Sequence[Sequence[int]],
           wanted: Sequence[Sequence[int]], precision: str = "f32",
           device=None) -> List[torch.Tensor]:
    """Float32 logits [len(wanted[i]), V] of sequence i at the positions
    wanted[i] (the logits at position t predict token t + 1)."""
    dev = torch.device(device) if device is not None else \
        model["final_norm"].device
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(shape, model, seqs, wanted, precision, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _logits(shape, model, seqs, wanted, precision, dev):
    D = shape["hidden_size"]
    L = shape["num_hidden_layers"]
    H, Hkv = shape["num_attention_heads"], shape["num_key_value_heads"]
    # its own copy of the harness's `costs.head_dim`, so that the
    # reference shares no code with what it judges
    hd = shape.get("head_dim") or D // H
    eps = shape["rms_norm_eps"]
    theta = shape["rope_theta"]
    layers = model["layers"]
    xs = [_embed(model, torch.tensor(list(s), dtype=torch.long, device=dev))
          for s in seqs]
    lens = [x.shape[0] for x in xs]
    x = torch.cat(xs)                       # every sequence's rows, stacked
    for l in range(L):
        h = _rms(x, layers["ln1"][l], eps)
        qkv = _lin(h, _mat(layers["wqkv"], l), precision)
        if "bqkv" in layers:
            qkv = qkv + layers["bqkv"][l].float()
        att = []
        for part in torch.split(qkv, lens):
            q = _rope(part[:, :H * hd].reshape(-1, H, hd), theta)
            k = _rope(part[:, H * hd:(H + Hkv) * hd].reshape(-1, Hkv, hd),
                      theta)
            v = part[:, (H + Hkv) * hd:].reshape(-1, Hkv, hd)
            att.append(_attention(q, k, v).reshape(-1, H * hd))
        x = x + _lin(torch.cat(att), _mat(layers["wo"], l), precision)
        h = _rms(x, layers["ln2"][l], eps)
        if "gate" in layers:
            x = x + _moe(shape, layers, l, h, precision)
        else:
            gu = _lin(h, _mat(layers["wgu"], l), precision)
            F_ = gu.shape[-1] // 2
            x = x + _lin(F.silu(gu[:, :F_]) * gu[:, F_:],
                         _mat(layers["wdown"], l), precision)
    head = _head(model)
    out, off = [], 0
    for n, pos in zip(lens, wanted):
        rows = x[off + torch.tensor(list(pos), dtype=torch.long, device=dev)]
        out.append(_lin(_rms(rows, model["final_norm"], eps), head, precision))
        off += n
    return out


def standardize(z: torch.Tensor) -> torch.Tensor:
    """(z - mean) / (std + 1e-6) over the vocabulary, population std."""
    mu = z.mean(-1, keepdim=True)
    return (z - mu) / (z.std(-1, keepdim=True, unbiased=False) + 1e-6)


def coupled_probs(small: torch.Tensor, big: torch.Tensor, lam: float,
                  temperature: float) -> torch.Tensor:
    """The coupled target's law over the small trunk's vocabulary:
    softmax((small + lam * standardize(big)) / temperature), the big
    trunk's logits cut to that vocabulary (its further rows are padding)."""
    big = big[..., :small.shape[-1]]
    return torch.softmax((small + lam * standardize(big)) / temperature, -1)


def tv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Total variation distance between the rows of two laws."""
    return 0.5 * (a.double() - b.double()).abs().sum(-1)


def rel_err(port: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per row: the largest |port - ref| over the vocabulary, over the
    reference row's standard deviation."""
    return ((port.double() - ref.double()).abs().amax(-1)
            / ref.double().std(-1, unbiased=False).clamp(min=1e-30))

