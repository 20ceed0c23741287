"""Experiment metric logging: JSONL sink + optional wandb (port of
`hsd_tpu/utils/logging.py`).

The reference logs training metrics to wandb in every trainer
(EAGLE-3H/eagle/traineagle3/main.py:222-226,287-296; train/main.py:67-76
region). Here the first-class sink is an append-only JSONL file (grep-able,
no network dependency) and wandb rides along when the package is importable
and enabled.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    """log({"loss": ..., "acc_0": ...}, step=n) -> one JSONL row (+wandb).

    Values may be python scalars, numpy scalars or one-element tensors
    (coerced with float(), which waits for a tensor on the card). Opens
    lazily, appends, flushes per row (crash-safe for long training runs)."""

    def __init__(self, path: Optional[str] = None, project: str = "hsd_tpu",
                 run_name: Optional[str] = None, use_wandb: bool = False,
                 config: Optional[Dict] = None):
        self.path = path
        self._fh = None
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # optional; not in the base image
                self._wandb = wandb
                wandb.init(project=project, name=run_name,
                           config=config or {})
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        row = {k: float(v) for k, v in metrics.items()}
        if step is not None:
            row["step"] = int(step)
        row["ts"] = time.time()
        if self.path is not None:
            if self._fh is None:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                self._fh = open(self.path, "a")
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(row, step=step)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._wandb is not None:
            self._wandb.finish()
