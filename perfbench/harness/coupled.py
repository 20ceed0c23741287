"""The coupled speculative pair as the slot pool serves it: the draft, the
coupled target's forward over flattened rows and its cache protocol
(`SlotPool`'s `target_forward` / `target_cache_ops`), composed from the
program's public `transformer.forward`, `kvcache.init_cache`, `put_rows`
and `select_rows`. A configuration's file calls `build`.

The target forward returns the coupled logits over the draft's vocabulary
(the big trunk's rows past it, padding in the published checkpoint, are
left out of the law; at lam 0 the big trunk's logits do not enter it at
all, and no standardization is computed); a `probe` (set by the harness
after the window) sees both trunks' logits of a verify.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from hsd_tpu_torch.config import ModelConfig
from hsd_tpu_torch.engine.kvcache import (KVCache, init_cache, put_rows,
                                          select_rows)
from hsd_tpu_torch.models import transformer
from hsd_tpu_torch.models.transformer import ModelParams, QuantizedEmbedding
from hsd_tpu_torch.ops.linear import QuantizedLinear

from . import weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class CoupledCache(NamedTuple):
    big: KVCache
    small: KVCache


class CoupledParams(NamedTuple):
    big: ModelParams
    small: ModelParams


class Served(NamedTuple):
    """What the harness serves and what the reference reads.

    A configuration whose block `reference/model.py` or `costs.py` does not
    compute gives its own per trunk ("draft", "small", "big"; a trunk left
    out keeps the default), e.g. `build(...)._replace(reference=...)`:
      reference  {trunk: logits(shape, model, seqs, wanted, precision,
                 device)}, the signature of `reference/model.logits`
                 (precision "f32", or "fp8" for the control); plain
                 float32 torch in a file of its own under `reference/`
      work       {trunk: work(seqs, head) -> (ops, bytes)}, seqs [(t new,
                 c cached)] as in `costs.forward`
    """
    cfg_draft: ModelConfig
    cfg_target: ModelConfig
    params_draft: ModelParams
    params_target: CoupledParams
    target_forward: Callable
    target_cache_ops: tuple
    raw: dict              # {"draft", "small", "big"}: raw models
    shapes: dict           # {"draft", "small", "big"}: reference shapes
    quant: dict            # {"draft", "small", "big"}: how each is stored
    lam: float
    target: "CoupledTarget"
    reference: Optional[dict] = None
    work: Optional[dict] = None


def port_config(shape: dict, eos: int) -> ModelConfig:
    """The program's ModelConfig for a configuration's sizes."""
    return ModelConfig(
        vocab_size=shape["vocab_size"], hidden_size=shape["hidden_size"],
        intermediate_size=shape["intermediate_size"],
        num_layers=shape["num_hidden_layers"],
        num_heads=shape["num_attention_heads"],
        num_kv_heads=shape["num_key_value_heads"],
        head_dim=shape.get("head_dim"),
        rope_theta=float(shape["rope_theta"]),
        rms_norm_eps=float(shape["rms_norm_eps"]),
        tie_word_embeddings=bool(shape.get("tie_word_embeddings", False)),
        attention_bias=bool(shape.get("attention_bias", False)),
        dtype=DTYPES[shape.get("served_dtype", "bfloat16")],
        eos_token_id=eos,
        num_experts=shape.get("num_local_experts", 0),
        num_experts_per_tok=shape.get("num_experts_per_tok", 2))


def _standardize(z: torch.Tensor) -> torch.Tensor:
    mu = torch.mean(z, dim=-1, keepdim=True)
    return (z - mu) / (torch.std(z, dim=-1, keepdim=True, unbiased=False)
                       + 1e-6)


class CoupledTarget:
    """The coupled target in SlotPool's protocol: forward(params, tokens
    [N, T], cache, lengths, skip_head=False) over N = slots x R rows
    (lengths None: an admission's prefill), and (init, put, select)."""

    def __init__(self, cfg_small: ModelConfig, cfg_big: ModelConfig,
                 lam: float, rows_per_slot: int):
        self.cfg_small, self.cfg_big = cfg_small, cfg_big
        self.lam, self.R = float(lam), rows_per_slot
        self.probe: Optional[Callable] = None

    def forward(self, params: CoupledParams, tokens, cache: CoupledCache,
                lengths, skip_head: bool = False):
        slots = tokens.shape[0] // self.R
        big, bigc = transformer.forward(self.cfg_big, params.big, tokens,
                                        cache.big, lengths=lengths,
                                        skip_head=skip_head, slots=slots)
        small, smallc = transformer.forward(self.cfg_small, params.small,
                                            tokens, cache.small,
                                            lengths=lengths,
                                            skip_head=skip_head, slots=slots)
        out = CoupledCache(big=bigc, small=smallc)
        if skip_head:
            return None, out
        if self.probe is not None:
            self.probe(big, small)
        if self.lam == 0.0:
            return small, out
        return small + self.lam * _standardize(big[..., :small.shape[-1]]), \
            out

    def init(self, batch, max_len, start, device):
        return CoupledCache(
            big=init_cache(self.cfg_big, batch, max_len, device).replace(
                start=start.clone()),
            small=init_cache(self.cfg_small, batch, max_len, device).replace(
                start=start.clone()))

    @staticmethod
    def put(pool: CoupledCache, rows, cache: CoupledCache, mask=None):
        return CoupledCache(big=put_rows(pool.big, rows, cache.big, mask),
                            small=put_rows(pool.small, rows, cache.small,
                                           mask))

    @staticmethod
    def select(cache: CoupledCache, src):
        return CoupledCache(big=select_rows(cache.big, src),
                            small=select_rows(cache.small, src))


def build(spec: dict, seed: int, device, rows_per_slot: int) -> Served:
    """The pair of a configuration file `spec`: the top level holds the
    target trunk's sizes, "draft" the draft's (the small trunk's too),
    "coupling" logit_scale and lam. Either trunk may state `head_dim`; the
    draft may state `tie_word_embeddings: false` (its own bf16 head)."""
    dev = torch.device(device)
    shape_big = dict(spec)
    shape_small = dict(spec["draft"])
    eos = int(spec["eos_token_id"])
    coupling = spec["coupling"]
    big = weights.big_trunk(shape_big, seed, dev)
    small = weights.small_trunk(shape_small, seed, coupling["logit_scale"],
                                dev)
    qc = shape_small.get("quantization_config", {})
    draft = weights.draft_of(small, sym=bool(qc.get("sym", False)))
    cfg_big = port_config(shape_big, eos)
    cfg_small = port_config(shape_small, eos)
    conv = dict(ql=QuantizedLinear, embedding=QuantizedEmbedding,
                params=ModelParams)
    target = CoupledTarget(cfg_small, cfg_big, coupling["lam"], rows_per_slot)
    return Served(
        cfg_draft=cfg_small, cfg_target=cfg_big,
        params_draft=weights.to_port(draft, **conv),
        params_target=CoupledParams(big=weights.to_port(big, **conv),
                                    small=weights.to_port(small, **conv)),
        target_forward=target.forward,
        target_cache_ops=(target.init, target.put, target.select),
        raw={"draft": draft, "small": small, "big": big},
        shapes={"draft": shape_small, "small": shape_small, "big": shape_big},
        quant={"draft": "int8sym" if qc.get("sym") else "int8asym",
               "small": "bf16", "big": "int4"},
        lam=float(coupling["lam"]), target=target)
