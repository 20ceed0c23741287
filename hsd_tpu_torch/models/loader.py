"""HF checkpoint loading: safetensors -> ModelParams on a device (port of
`hsd_tpu/models/loader.py`).

Covers the checkpoints the JAX loader takes:
  * plain f32 / f16 Qwen2, Llama and Mixtral checkpoints;
  * GPTQ weight-only checkpoints (the auto-gptq layout: int32-packed
    qweight and qzeros, f16 scales, usually group 128; v1 and gptq_v2 zero
    points; desc_act g_idx), unpacked into QuantizedLinear's layout:
    int8 codes, or packed int4 in split-half nibbles;
  * Mixtral's `block_sparse_moe` router and expert stacks [L, E, ...].

The safetensors files are read here (`read_safetensors`): an 8-byte
little-endian header length, a JSON header of dtype / shape /
data_offsets, then the raw bytes, mapped with numpy.memmap so that a file
is never held twice. Tensors cross to the device one at a time; the GPTQ
unpacking, the desc_act re-sort and the nibble packing run there in torch.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.linear import QuantizedLinear
from .eagle import EagleParams
from .transformer import (ModelParams, QuantizedEmbedding, quantize_embedding,
                          resolve_device)

# the dtypes safetensors.numpy reads with numpy alone; any other (BF16 and
# the F8 types, which need ml_dtypes there) raises
_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "U64": np.uint64, "I32": np.int32, "U32": np.uint32,
    "I16": np.int16, "U16": np.uint16, "I8": np.int8, "U8": np.uint8,
    "BOOL": np.bool_, "C64": np.complex64,
}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of one .safetensors file as a read-only numpy view of
    the file's memory map (nothing is read until a view is used)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}, which this reader does not "
                             f"take")
        dt = np.dtype(_DTYPES[info["dtype"]])
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        if end - begin != int(np.prod(shape)) * dt.itemsize or end > len(data):
            raise ValueError(f"{path}: tensor {name}'s data_offsets "
                             f"{begin}..{end} do not hold {shape} {dt}")
        out[name] = data[begin:end].view(dt).reshape(shape)
    return out


def _load_all_tensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a checkpoint directory. With
    `model.safetensors.index.json` (a sharded checkpoint): exactly the
    files its weight_map names, each once, and every mapped key must land
    (a truncated download fails loudly). Else every *.safetensors file."""
    tensors = {}
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        for fname in sorted(set(weight_map.values())):
            fp = os.path.join(path, fname)
            if not os.path.exists(fp):
                raise FileNotFoundError(
                    f"index names {fname} but it is missing under {path}")
            tensors.update(read_safetensors(fp))
        missing = [k for k in weight_map if k not in tensors]
        if missing:
            raise ValueError(f"index keys missing from shards: {missing[:5]}"
                             f"{'...' if len(missing) > 5 else ''}")
        return tensors
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors under {path}")
    for f in files:
        tensors.update(read_safetensors(f))
    return tensors


def read_quant_config(path: str) -> Optional[Dict]:
    """GPTQ metadata from `quantization_config` in config.json (HF) or a
    standalone `quantize_config.json` (auto-gptq), normalized to {bits,
    group_size, sym, desc_act, zero_offset}; None if unquantized.
    zero_offset: 1 for auto-gptq v1 (w = scale * (code - (qzero + 1))), 0
    for "gptq_v2" (w = scale * (code - qzero))."""
    qc = None
    cfgp = os.path.join(path, "config.json")
    if os.path.exists(cfgp):
        with open(cfgp) as f:
            qc = json.load(f).get("quantization_config")
    if qc is None:
        qcp = os.path.join(path, "quantize_config.json")
        if os.path.exists(qcp):
            with open(qcp) as f:
                qc = json.load(f)
    if qc is None or qc.get("quant_method", "gptq") != "gptq":
        return None
    fmt = qc.get("checkpoint_format", "gptq")
    return {
        "bits": int(qc["bits"]),
        "group_size": int(qc.get("group_size", 128)),
        "sym": bool(qc.get("sym", True)),
        "desc_act": bool(qc.get("desc_act", False)),
        "zero_offset": 0 if fmt == "gptq_v2" else 1,
    }


def config_from_hf(path: str) -> ModelConfig:
    """A ModelConfig (bf16) from an HF config.json of the Qwen2, Llama or
    Mixtral family."""
    with open(os.path.join(path, "config.json")) as f:
        c = json.load(f)
    eos = c.get("eos_token_id")
    if isinstance(eos, list):
        eos = eos[0]
    rs = c.get("rope_scaling")
    rope_scaling = None
    if rs and rs.get("rope_type", rs.get("type")) == "llama3":
        rope_scaling = (float(rs["factor"]), float(rs["low_freq_factor"]),
                        float(rs["high_freq_factor"]),
                        int(rs["original_max_position_embeddings"]))
    return ModelConfig(
        rope_scaling=rope_scaling,
        vocab_size=c["vocab_size"],
        hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c.get("num_key_value_heads", c["num_attention_heads"]),
        head_dim=c.get("head_dim"),
        rope_theta=c.get("rope_theta", 10000.0),
        rms_norm_eps=c.get("rms_norm_eps", 1e-6),
        tie_word_embeddings=c.get("tie_word_embeddings", False),
        attention_bias=c.get("model_type", "qwen2") == "qwen2",
        eos_token_id=eos if eos is not None else 0,
        num_experts=c.get("num_local_experts", 0),
        num_experts_per_tok=c.get("num_experts_per_tok", 2),
    )


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """A copy of a (memory-mapped, read-only) array on the device."""
    return torch.from_numpy(np.array(a)).to(device)


def _unpack_gptq_int32(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """auto-gptq int32 rows -> unsigned codes along axis 0: [in * bits / 32,
    out] int32 -> [in, out] uint8 in [0, 2^bits). The shift is arithmetic,
    and the mask keeps only the field's own bits."""
    per = 32 // bits
    mask = (1 << bits) - 1
    out = torch.empty((packed.shape[0] * per, packed.shape[1]),
                      dtype=torch.uint8, device=packed.device)
    for j in range(per):
        out[j::per] = ((packed >> (bits * j)) & mask).to(torch.uint8)
    return out


def _gptq_linear(t: Dict[str, np.ndarray], prefix: str, bits: int,
                 zero_offset: int = 1, device=None) -> QuantizedLinear:
    """One auto-gptq layer -> QuantizedLinear, as the JAX loader converts it
    (`_gptq_linear`): w = (code - zero) * scale with signed codes, the
    2^(bits-1) shift folded into zero (v1: zero = qzero + 1 - 2^(bits-1);
    gptq_v2 drops the +1); a symmetric export without qzeros gets
    zeros=None. A desc_act g_idx (row i in group g_idx[i]) re-sorts the rows
    by a stable argsort into `perm`, which apply_linear gathers the
    activations by; ragged groups raise. 4-bit codes stay packed, split-half
    (row i | row i + in/2), stored unsigned: the raw GPTQ codes. On the
    card unless `device` says otherwise."""
    device = resolve_device(device)
    qweight = _unpack_gptq_int32(_tensor(t[prefix + ".qweight"], device),
                                 bits)                              # [in, out]
    scales = _tensor(t[prefix + ".scales"], device).float()     # [groups, out]
    groups = scales.shape[0]
    din = qweight.shape[0]
    gs = din // groups
    perm = None
    g_idx = t.get(prefix + ".g_idx")
    if g_idx is not None:
        g_idx = np.asarray(g_idx, np.int64)
        if not np.array_equal(g_idx, np.arange(din) // gs):
            counts = np.bincount(g_idx, minlength=groups)
            if not (counts == gs).all():
                raise NotImplementedError(
                    f"ragged g_idx groups (sizes {sorted(set(counts))}) "
                    f"not supported")
            perm = torch.from_numpy(
                np.argsort(g_idx, kind="stable")).to(device)
            qweight = qweight[perm]
    offset = 1 << (bits - 1)
    zeros = None
    qz = t.get(prefix + ".qzeros")
    if qz is not None:
        qzeros = _unpack_gptq_int32(_tensor(qz, device).t().contiguous(),
                                    bits).t()                  # [groups, out]
        zeros = (qzeros.float() + zero_offset) - offset
    if bits == 4 and din % 2 == 0:
        c = qweight.to(torch.int32)
        half = din // 2
        q = (((c[half:] & 0xF) << 4) | (c[:half] & 0xF)).to(torch.uint8)
    else:
        q = (qweight.to(torch.int16) - offset).to(torch.int8)
    return QuantizedLinear(qweight=q, scales=scales,
                           zeros=None if zeros is None else zeros.contiguous(),
                           perm=perm)


def _dense(t: Dict[str, np.ndarray], name: str, dtype, device,
           transpose: bool = True) -> torch.Tensor:
    """An HF [out, in] matrix as [in, out] (transpose) in `dtype`, through
    f32 as the JAX loader rounds it."""
    w = _tensor(t[name], device).float()
    if transpose and w.dim() == 2:
        w = w.t()
    return w.to(dtype).contiguous()


def _stack_q(qs) -> QuantizedLinear:
    """Stack QuantizedLinear weights on a new leading axis. If any carries
    a perm, the others get the identity (a desc_act export may leave some
    matrices in order), at whatever depth the perm is missing."""
    if any(q.perm is not None for q in qs):
        def ident(q):
            ar = torch.arange(q.din, device=q.qweight.device)
            return ar.expand(*q.qweight.shape[:-2], q.din)
        qs = [q if q.perm is not None else q._replace(perm=ident(q))
              for q in qs]
    return QuantizedLinear(
        qweight=torch.stack([q.qweight for q in qs]),
        scales=torch.stack([q.scales for q in qs]),
        zeros=(None if qs[0].zeros is None
               else torch.stack([q.zeros for q in qs])),
        perm=(None if qs[0].perm is None
              else torch.stack([q.perm for q in qs])))


def load_hf(path: str, cfg: Optional[ModelConfig] = None,
            quantized: Optional[int] = None, quantize_embed: bool = False,
            device=None) -> tuple:
    """Load an HF Qwen2 / Llama / Mixtral checkpoint directory onto
    `device` (the card unless the caller passes another).

    quantized: None to take the bits from the checkpoint's quantization
      config (read_quant_config: bits, and the v1 / v2 zero convention),
      8 or 4 to force GPTQ bits on a configless checkpoint.
    quantize_embed: also quantize the embedding per row to int8 (needs an
      untied head).
    Returns (cfg, ModelParams) with layer weights stacked on axis 0, MoE
    experts on axes (0, 1). An untied config whose checkpoint has no
    lm_head.weight comes back tied to the embedding.
    """
    dev = resolve_device(device)
    cfg = cfg or config_from_hf(path)
    t = _load_all_tensors(path)
    L, dt = cfg.num_layers, cfg.dtype
    qc = read_quant_config(path)
    zero_offset = 1
    if qc is not None:
        if quantized is None:
            quantized = qc["bits"]
        zero_offset = qc["zero_offset"]

    def q_or_dense(name):
        if quantized:
            return _gptq_linear(t, name, quantized, zero_offset, dev)
        return _dense(t, name + ".weight", dt, dev)

    def stack(ws):
        if isinstance(ws[0], QuantizedLinear):
            return _stack_q(ws)
        return torch.stack(ws)

    def mat(name):
        return stack([q_or_dense(f"model.layers.{i}.{name}")
                      for i in range(L)])

    def vec(fmt, dtype=torch.float32):
        return torch.stack([_tensor(t[fmt.format(i)], dev).float()
                            for i in range(L)]).to(dtype)

    layers = dict(
        ln1=vec("model.layers.{}.input_layernorm.weight"),
        ln2=vec("model.layers.{}.post_attention_layernorm.weight"),
        wq=mat("self_attn.q_proj"),
        wk=mat("self_attn.k_proj"),
        wv=mat("self_attn.v_proj"),
        wo=mat("self_attn.o_proj"),
    )
    if cfg.is_moe:
        # Mixtral: block_sparse_moe.gate and experts.{e}.w1 / w3 / w2
        # (gate, up, down), stacked [L, E, in, out]
        moe = "model.layers.{}.block_sparse_moe."

        def experts(wname):
            return stack([stack([q_or_dense(
                moe.format(i) + f"experts.{e}.{wname}")
                for e in range(cfg.num_experts)]) for i in range(L)])

        layers.update(
            gate=torch.stack([_dense(t, moe.format(i) + "gate.weight",
                                     torch.float32, dev) for i in range(L)]),
            wgate=experts("w1"), wup=experts("w3"), wdown=experts("w2"))
    else:
        layers.update(wgate=mat("mlp.gate_proj"), wup=mat("mlp.up_proj"),
                      wdown=mat("mlp.down_proj"))
    if cfg.attention_bias and "model.layers.0.self_attn.q_proj.bias" in t:
        layers.update(
            bq=vec("model.layers.{}.self_attn.q_proj.bias", dt),
            bk=vec("model.layers.{}.self_attn.k_proj.bias", dt),
            bv=vec("model.layers.{}.self_attn.v_proj.bias", dt))

    embed = _dense(t, "model.embed_tokens.weight", dt, dev, transpose=False)
    lm_head = None
    if not cfg.tie_word_embeddings:
        if "lm_head.weight" in t:
            lm_head = _dense(t, "lm_head.weight", dt, dev)         # [D, V]
        else:
            # some exports declare an untied head and omit lm_head.weight
            cfg = dataclasses.replace(cfg, tie_word_embeddings=True)
    if quantize_embed:
        if cfg.tie_word_embeddings:
            raise ValueError("quantize_embed requires an untied lm_head")
        embed = quantize_embedding(embed)
    final_norm = _tensor(t["model.norm.weight"], dev).float()
    return cfg, ModelParams(embed=embed, layers=layers,
                            final_norm=final_norm, lm_head=lm_head)


def _truncate_vocab(cfg: ModelConfig, params: ModelParams, V: int):
    """Slice one model's vocab-sized tensors down to V rows / columns."""
    if cfg.vocab_size == V:
        return cfg, params
    if cfg.vocab_size < V:
        raise ValueError(f"cannot widen vocab {cfg.vocab_size} to {V}")
    if cfg.eos_token_id >= V:
        raise ValueError(f"eos_token_id {cfg.eos_token_id} would be "
                         f"truncated (V={V})")
    embed = params.embed
    if isinstance(embed, QuantizedEmbedding):
        embed = QuantizedEmbedding(codes=embed.codes[:V],
                                   scale=embed.scale[:V])
    else:
        embed = embed[:V]
    lm_head = params.lm_head
    if isinstance(lm_head, QuantizedLinear):
        lm_head = QuantizedLinear(
            qweight=lm_head.qweight[..., :V], scales=lm_head.scales[..., :V],
            zeros=None if lm_head.zeros is None else lm_head.zeros[..., :V])
    elif lm_head is not None:
        lm_head = lm_head[:, :V]
    return (dataclasses.replace(cfg, vocab_size=V),
            params._replace(embed=embed, lm_head=lm_head))


def align_vocab(cfg_a: ModelConfig, params_a: ModelParams,
                cfg_b: ModelConfig, params_b: ModelParams):
    """Truncate both models' vocabularies to the common minimum (views):
    verification compares whole q / p rows, so draft and target must emit
    one width (Qwen2.5 0.5B has 151936, 14B and up 152064). Embedding rows
    and head columns are sliced, for dense, tied, QuantizedLinear and
    QuantizedEmbedding alike; an EOS id past the cut raises. Returns
    (cfg_a', params_a', cfg_b', params_b')."""
    V = min(cfg_a.vocab_size, cfg_b.vocab_size)
    cfg_a, params_a = _truncate_vocab(cfg_a, params_a, V)
    cfg_b, params_b = _truncate_vocab(cfg_b, params_b, V)
    return cfg_a, params_a, cfg_b, params_b


def load_eagle_hf(path: str, target_embed: torch.Tensor,
                  dtype=torch.bfloat16, device=None) -> EagleParams:
    """An EAGLE-3 head checkpoint (the fused decoder layer under
    `midlayer.*` plus fc / norm / lm_head / d2t / t2d) as EagleParams on
    `device`, over the frozen target's embedding `target_embed`. Without
    d2t / t2d the draft vocab is the target's."""
    dev = resolve_device(device)
    t = _load_all_tensors(path)

    def g(name):
        return _dense(t, name, dtype, dev)

    def norm(name):
        return _tensor(t[name], dev).float()

    vd = t["lm_head.weight"].shape[0]
    V = target_embed.shape[0]
    d2t, t2d = t.get("d2t"), t.get("t2d")
    return EagleParams(
        embed=target_embed.to(dev, dtype),
        fc=g("fc.weight"),
        ln_input=norm("midlayer.input_layernorm.weight"),
        ln_hidden=norm("midlayer.hidden_norm.weight"),
        wq=g("midlayer.self_attn.q_proj.weight"),
        wk=g("midlayer.self_attn.k_proj.weight"),
        wv=g("midlayer.self_attn.v_proj.weight"),
        wo=g("midlayer.self_attn.o_proj.weight"),
        ln_post=norm("midlayer.post_attention_layernorm.weight"),
        wgate=g("midlayer.mlp.gate_proj.weight"),
        wup=g("midlayer.mlp.up_proj.weight"),
        wdown=g("midlayer.mlp.down_proj.weight"),
        norm=norm("norm.weight"),
        lm_head=g("lm_head.weight"),
        d2t=(_tensor(d2t, dev).long() if d2t is not None
             else torch.zeros((vd,), dtype=torch.int64, device=dev)),
        t2d=(_tensor(t2d, dev).bool() if t2d is not None
             else torch.ones((V,), dtype=torch.bool, device=dev)))
