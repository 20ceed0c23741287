"""The served pair's weights, made on the device from the seed: a frozen
plain-torch copy of the synthetic coupled pair's construction
(`bench.py:59-138`), independent of the program's own initializers.

    q = softmax(draft(x))                          # asymmetric int8 0.5B
    p = softmax(small(x) + lam * standardize(big(x)))

`small` is the bf16 0.5B trunk, its embedding (tied to its head) scaled by
`logit_scale` (or, where the draft's head is untied, its own bf16 head
scaled instead); `draft` its int8 image (round to nearest, one scale a group
of 128 input rows, as GPTQ stores them: symmetric where the draft's
`quantization_config` says `sym`, else with a zero point a group too);
`big` a packed-int4 trunk with uniform codes and bf16 scales |N(0, 1)| *
1e-2 + 1e-3 a group of 128 input rows, an int8 embedding (scale 2e-4 a
row) and an untied int4 head; for MoE a float32 router N(0, 1/D) and
unfused expert stacks.

A raw model is a dict: "embed" (a dense tensor, or {"codes", "scale"}),
"layers" ({name: stacked tensor or {"codes", "scales", "zeros", "bits"}}),
"final_norm", "lm_head" (None when tied; a dense [D, V] tensor or a
quantized one). Attention is `head_dim` wide a head where the
configuration states it, else hidden_size over the heads. Every tensor is
drawn in one call per stack, in the type it is served in. Both the program
(`to_port`) and the reference read these same tensors.
"""
from __future__ import annotations

import torch

from . import costs

GROUP = 128


def _gen(seed: int, stream: int, dev) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


def _int4(gen, dev, lead, din: int, dout: int) -> dict:
    codes = torch.randint(0, 256, (*lead, din // 2, dout), generator=gen,
                          device=dev, dtype=torch.uint8)
    scales = (torch.randn((*lead, din // GROUP, dout), generator=gen,
                          device=dev).abs_().mul_(1e-2).add_(1e-3)
              ).to(torch.bfloat16)
    return {"codes": codes, "scales": scales, "zeros": None, "bits": 4}


def big_trunk(shape: dict, seed: int, dev) -> dict:
    """The packed-int4 target trunk at the configuration's widths."""
    gen = _gen(seed, 0, dev)
    D, Fi = shape["hidden_size"], shape["intermediate_size"]
    L, V = shape["num_hidden_layers"], shape["vocab_size"]
    H, Hkv = shape["num_attention_heads"], shape["num_key_value_heads"]
    hd = costs.head_dim(shape)
    layers = {"ln1": torch.ones((L, D), device=dev),
              "ln2": torch.ones((L, D), device=dev),
              "wqkv": _int4(gen, dev, (L,), D, (H + 2 * Hkv) * hd),
              "wo": _int4(gen, dev, (L,), H * hd, D)}
    E = shape.get("num_local_experts", 0)
    if E:
        layers["gate"] = torch.randn((L, D, E), generator=gen,
                                     device=dev) * D ** -0.5
        layers["wgate"] = _int4(gen, dev, (L, E), D, Fi)
        layers["wup"] = _int4(gen, dev, (L, E), D, Fi)
        layers["wdown"] = _int4(gen, dev, (L, E), Fi, D)
    else:
        layers["wgu"] = _int4(gen, dev, (L,), D, 2 * Fi)
        layers["wdown"] = _int4(gen, dev, (L,), Fi, D)
    if shape.get("attention_bias"):
        layers["bqkv"] = torch.zeros((L, (H + 2 * Hkv) * hd),
                                     dtype=torch.bfloat16, device=dev)
    codes = torch.randint(-127, 128, (V, D), generator=gen, device=dev,
                          dtype=torch.int8)
    return {"embed": {"codes": codes,
                      "scale": torch.full((V,), 2e-4, device=dev)},
            "layers": layers, "final_norm": torch.ones((D,), device=dev),
            "lm_head": _int4(gen, dev, (), D, V)}


def small_trunk(shape: dict, seed: int, logit_scale: float, dev) -> dict:
    """The bf16 small trunk: N(0, 1) * L**-0.5 layer stacks (the synthetic
    init's scale), q|k|v and gate|up fused, zero qkv bias, an N(0, 1) *
    0.02 embedding, rounded to bf16, then times logit_scale, tied head.
    Where the configuration states `tie_word_embeddings: false`, the head
    is its own: an N(0, 1) * 0.02 [D, V] matrix drawn after the embedding,
    rounded to bf16, then times logit_scale, and the embedding stays
    unscaled."""
    gen = _gen(seed, 1, dev)
    D, Fi = shape["hidden_size"], shape["intermediate_size"]
    L, V = shape["num_hidden_layers"], shape["vocab_size"]
    H, Hkv = shape["num_attention_heads"], shape["num_key_value_heads"]
    hd = costs.head_dim(shape)
    bf = torch.bfloat16

    def dense(*s):
        return (torch.randn(s, generator=gen, device=dev) * L ** -0.5).to(bf)

    layers = {"ln1": torch.ones((L, D), device=dev),
              "ln2": torch.ones((L, D), device=dev),
              "wqkv": dense(L, D, (H + 2 * Hkv) * hd),
              "wo": dense(L, H * hd, D),
              "wgu": dense(L, D, 2 * Fi),
              "wdown": dense(L, Fi, D)}
    if shape.get("attention_bias"):
        layers["bqkv"] = torch.zeros((L, (H + 2 * Hkv) * hd), dtype=bf,
                                     device=dev)
    embed = (torch.randn((V, D), generator=gen, device=dev) * 0.02).to(bf)
    head = None
    if shape.get("tie_word_embeddings", True):
        embed = (embed.float() * logit_scale).to(bf)
    else:
        head = (torch.randn((D, V), generator=gen, device=dev) * 0.02).to(bf)
        head = (head.float() * logit_scale).to(bf)
    return {"embed": embed, "layers": layers,
            "final_norm": torch.ones((D,), device=dev), "lm_head": head}


def quantize_asym8(w: torch.Tensor) -> dict:
    """Asymmetric int8 of stacked [L, in, out] weights, one scale and zero
    point a group of 128 input rows: scale = (max - min) / 255, zero =
    min / scale + 128, code = clamp(round(w / scale - zero), -128, 127),
    stored zero point -zero, so w ~ (code - stored) * scale."""
    L, din, dout = w.shape
    g = din // GROUP
    wf = w.float().reshape(L, g, GROUP, dout)
    lo, hi = wf.amin(2), wf.amax(2)
    scale = ((hi - lo) / 255.0).clamp(min=1e-8)
    zero = lo / scale + 128.0
    codes = torch.clamp(torch.round(wf / scale[:, :, None] - zero[:, :, None]),
                        -128, 127).to(torch.int8).reshape(L, din, dout)
    return {"codes": codes, "scales": scale, "zeros": -zero, "bits": 8}


def quantize_sym8(w: torch.Tensor) -> dict:
    """Symmetric int8 of stacked [L, in, out] weights, one scale a group of
    128 input rows: scale = max |w| / 127, code = clamp(round(w / scale),
    -128, 127), no zero point, so w ~ code * scale."""
    L, din, dout = w.shape
    g = din // GROUP
    wf = w.float().reshape(L, g, GROUP, dout)
    scale = (wf.abs().amax(2) / 127.0).clamp(min=1e-8)
    codes = torch.clamp(torch.round(wf / scale[:, :, None]), -128, 127
                        ).to(torch.int8).reshape(L, din, dout)
    return {"codes": codes, "scales": scale, "zeros": None, "bits": 8}


def draft_of(small: dict, sym: bool) -> dict:
    """The draft: the small trunk's products in int8 (symmetric or
    asymmetric), its embedding, head (tied or its own), norms and bias
    shared."""
    quantize = quantize_sym8 if sym else quantize_asym8
    layers = dict(small["layers"])
    for name in ("wqkv", "wo", "wgu", "wdown"):
        layers[name] = quantize(layers[name])
    return dict(small, layers=layers)


def to_port(model: dict, ql, embedding, params):
    """The program's parameter tuple over the same tensors (no copy). ql,
    embedding, params: the program's QuantizedLinear, QuantizedEmbedding and
    ModelParams types."""
    def conv(w):
        if isinstance(w, dict) and "bits" in w:
            return ql(qweight=w["codes"], scales=w["scales"],
                      zeros=w["zeros"])
        return w

    e = model["embed"]
    embed = embedding(codes=e["codes"], scale=e["scale"]) \
        if isinstance(e, dict) else e
    return params(embed=embed,
                  layers={k: conv(v) for k, v in model["layers"].items()},
                  final_norm=model["final_norm"],
                  lm_head=None if model["lm_head"] is None
                  else conv(model["lm_head"]))
