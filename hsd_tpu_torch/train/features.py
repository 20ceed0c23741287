"""Offline pre-computed feature training — the reference's CustomDataset
mode (EAGLE-3H/eagle/train/main.py:133-172); port of
`hsd_tpu/train/features.py`.

`dump_features` runs the frozen target ONCE over the conversation batches
and writes one .npz shard per batch; `offline_data_epochs` replays the
shards (shuffled per epoch) as dict batches for `train_loop`; the
`make_*_offline` steps in eagle3/eagle1 consume them with NO target
forward, so the target's cost is paid once per dataset, not once per
epoch.

Shard contents (float16 on disk; the step upcasts), the JAX package's keys,
so either package reads the other's shards:
  v3: ids [B, T] i32, mask [B, T] f16, feats [B, T, nF*D] f16,
      logits [B, T, V] f16
  v1: ids, mask, hidden [B, T, D] f16
meta.json records version/feature_layers/count for the loader to check.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..models.transformer import resolve_device
from .eagle3 import final_hidden, target_stream


def _f16(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float16).cpu().numpy()


def dump_features(cfg_t: ModelConfig, params_t, batches: Iterable,
                  out_dir: str, feature_layers: Optional[Tuple] = None,
                  version: int = 3, device=None) -> int:
    """Run the target over `batches` of (ids, mask) on `device` (the card
    unless given; params_t must live there) and write shards. Returns the
    number of shards written."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for ids, mask in batches:
        ids = np.ascontiguousarray(ids, np.int32)
        mask = np.asarray(mask, np.float16)
        ids_t = torch.from_numpy(ids).to(dev).long()
        path = os.path.join(out_dir, f"shard_{n:06d}.npz")
        if version == 3:
            logits, feats = target_stream(cfg_t, params_t, ids_t,
                                          feature_layers)
            np.savez(path, ids=ids, mask=mask, feats=_f16(feats),
                     logits=_f16(logits))
        else:
            np.savez(path, ids=ids, mask=mask,
                     hidden=_f16(final_hidden(cfg_t, params_t, ids_t)))
        n += 1
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"version": version, "count": n,
                   "feature_layers": list(feature_layers or ())}, f)
    return n


def offline_meta(features_dir: str) -> dict:
    with open(os.path.join(features_dir, "meta.json")) as f:
        return json.load(f)


def offline_data_epochs(features_dir: str, seed: int = 0, device=None
                        ) -> Callable[[int], Iterable[dict]]:
    """`data_epochs(epoch) -> iterable of dict batches` over the shards,
    file order shuffled per epoch by `default_rng(seed + epoch)` (the JAX
    package's order); tensors upcast to f32 on `device` (the card unless
    given). Dict batches are splatted into the offline steps."""
    dev = resolve_device(device)
    meta = offline_meta(features_dir)
    files = sorted(f for f in os.listdir(features_dir)
                   if f.startswith("shard_") and f.endswith(".npz"))
    if len(files) != meta["count"]:
        raise ValueError(f"{features_dir}: {len(files)} shards, meta.json "
                         f"says {meta['count']}")
    version = meta["version"]

    def tensor(a, dtype):
        return torch.from_numpy(np.asarray(a)).to(dev).to(dtype)

    def epochs(epoch: int):
        order = np.random.default_rng(seed + epoch).permutation(len(files))
        for i in order:
            with np.load(os.path.join(features_dir, files[i])) as z:
                batch = {"input_ids": tensor(z["ids"], torch.int64),
                         "loss_mask": tensor(z["mask"], torch.float32)}
                if version == 3:
                    batch["features"] = tensor(z["feats"], torch.float32)
                    batch["target_logits"] = tensor(z["logits"],
                                                    torch.float32)
                else:
                    batch["hidden"] = tensor(z["hidden"], torch.float32)
            yield batch

    return epochs
