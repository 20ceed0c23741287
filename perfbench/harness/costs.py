"""The work a forward needs, from shapes: operations and bytes read once.

A forward runs some sequences, each `t` new tokens after `c` tokens
already in its cache. It needs
  ops    2 * t * (every product's in x out) for each sequence's tokens,
         with an MoE layer's experts at the routed top-k only, plus
         attention's QK and PV over the c + (t + 1) / 2 keys a new token
         sees on average (causal), and the head where it is applied;
  bytes  every weight the forward touches, once: packed int4 at half a
         byte a weight, int8 at one, bf16 at two, each group's scale (and
         zero point), an MoE layer's experts that received a token (at n
         routed rows, E * (1 - (1 - k / E) ** n) of E, the expectation
         under a router that spreads tokens evenly), the embedding rows
         read, and the KV cache read over the c committed positions and
         written for the t new ones (bf16).
Padding rows, and rows of slots that hold no live request, are work that
no request needs: they are not counted.
"""
from __future__ import annotations

from typing import Iterable, Tuple

GROUP = 128
KV_BYTES = 2          # bf16 cache


def _matrix_bytes(din: int, dout: int, bits: int, zeros: bool) -> float:
    w = din * dout * bits / 8
    groups = din // GROUP * dout
    scale = 4 if bits == 8 else 2          # int8: f32 scales; int4: bf16
    return w + groups * scale * (2 if zeros else 1)


def head_dim(shape: dict) -> int:
    """The configuration's `head_dim` where it states one, else hidden_size
    over the heads."""
    return shape.get("head_dim") or \
        shape["hidden_size"] // shape["num_attention_heads"]


def trunk(shape: dict, quant: str) -> dict:
    """Per-layer product shapes and weight bytes of a trunk. quant: 'int4'
    (symmetric, packed), 'int8sym', 'int8asym' or 'bf16'."""
    D, F = shape["hidden_size"], shape["intermediate_size"]
    H, Hkv = shape["num_attention_heads"], shape["num_key_value_heads"]
    hd = head_dim(shape)
    E = shape.get("num_local_experts", 0)
    k = shape.get("num_experts_per_tok", 0)
    V = shape["vocab_size"]
    attn = [(D, (H + 2 * Hkv) * hd), (H * hd, D)]
    ffn = [(D, 2 * F), (F, D)]
    if quant == "bf16":
        def wb(din, dout):
            return din * dout * 2.0
    else:
        bits = 4 if quant == "int4" else 8
        zeros = quant == "int8asym"

        def wb(din, dout):
            return _matrix_bytes(din, dout, bits, zeros)
    tied = shape.get("tie_word_embeddings", False)
    return dict(
        D=D, H=H, Hkv=Hkv, hd=hd, E=E, k=k, V=V,
        L=shape["num_hidden_layers"],
        attn_macs=sum(a * b for a, b in attn),
        ffn_macs=sum(a * b for a, b in ffn),
        attn_bytes=sum(wb(a, b) for a, b in attn),
        ffn_bytes=sum(wb(a, b) for a, b in ffn),
        router_macs=D * E,
        head_macs=D * V,
        head_bytes=D * V * 2.0 if tied or quant != "int4" else wb(D, V),
        embed_row_bytes=D * (2 if tied or quant != "int4" else 1))


def forward(tr: dict, seqs: Iterable[Tuple[int, int]],
            head: bool) -> Tuple[float, float]:
    """(ops, bytes) of one forward over `seqs` [(t new tokens, c cached)]."""
    seqs = list(seqs)
    n = sum(t for t, _ in seqs)
    if n == 0:
        return 0.0, 0.0
    L, H, Hkv, hd = tr["L"], tr["H"], tr["Hkv"], tr["hd"]
    ops = 2.0 * n * tr["attn_macs"] * L
    att = sum(t * (c + (t + 1) / 2) for t, c in seqs)
    ops += 2.0 * 2.0 * H * hd * att * L
    byts = tr["attn_bytes"] * L + n * tr["embed_row_bytes"]
    kv = 2 * Hkv * hd * KV_BYTES
    byts += sum(c + t for t, c in seqs) * kv * L
    if tr["E"]:
        E, k = tr["E"], tr["k"]
        ops += 2.0 * n * (k * tr["ffn_macs"] + tr["router_macs"]) * L
        hit = E * (1.0 - (1.0 - k / E) ** n)
        byts += hit * tr["ffn_bytes"] * L + tr["router_macs"] * 4 * L
    else:
        ops += 2.0 * n * tr["ffn_macs"] * L
        byts += tr["ffn_bytes"] * L
    if head:
        ops += 2.0 * n * tr["head_macs"]
        byts += tr["head_bytes"]
    return ops, byts


def least_seconds(ops: float, byts: float, peaks: dict) -> Tuple[float, str]:
    """The roofline's least time of one forward and what binds it."""
    t_ops = ops / peaks["bf16_flops_per_s"]
    t_bytes = byts / peaks["hbm_bytes_per_s"]
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
