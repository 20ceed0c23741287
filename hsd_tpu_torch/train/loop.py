"""Generic training-loop driver: auto-resume + checkpoint cadence + logging
(port of `hsd_tpu/train/loop.py`).

The reference wraps its trainers in per-launcher main.py loops (DeepSpeed:
EAGLE-3H/eagle/traineagle3/main.py:262-347 with find_max_state_with_file
auto-resume, save_16bit_model each epoch, full checkpoint every 10 epochs,
wandb metrics; accelerate: train/main.py:336-469). This loop is the shared
body for both the EAGLE-1/2 (train/eagle1.py) and EAGLE-3 (train/eagle3.py)
steps.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

from ..utils.logging import MetricLogger
from ..utils.profiling import synchronize
from .eagle3 import (TrainState, latest_checkpoint_step, restore_checkpoint,
                     save_checkpoint)


def train_loop(state: TrainState,
               step_fn: Callable,
               params_target,
               data_epochs: Callable[[int], Iterable],
               num_epochs: int,
               ckpt_dir: Optional[str] = None,
               save_every_epochs: int = 1,
               logger: Optional[MetricLogger] = None,
               log_every: int = 10,
               epoch_probe: Optional[Callable] = None,
               probe_batches: int = 10) -> TrainState:
    """Run `num_epochs` over `data_epochs(epoch) -> iterable of (ids, mask)`
    or of dict batches (offline feature shards).

    - auto-resume: when ckpt_dir holds a state_N directory, restores it and
      skips the already-consumed LEADING batches of the epoch stream (the
      reference resumes at epoch granularity, traineagle3/main.py:239-263;
      here resume is step-exact within the epoch);
    - checkpoints every `save_every_epochs` epochs (and at the end), unless
      the latest one already holds this step;
    - logs step metrics every `log_every` steps via MetricLogger;
    - epoch_probe: optional `probe(params_e, params_target, ids, mask) ->
      metrics` run after every epoch on up to `probe_batches` fresh batches
      (the reference's between-epoch getkacc evaluation on <=10 test
      batches, train/main.py:420-424; use `train.probes.make_kacc_probe`),
      mean-aggregated and logged with an `eval/` prefix.
    """
    start_step = 0
    if ckpt_dir is not None:
        latest = latest_checkpoint_step(ckpt_dir)
        if latest is not None:
            state = restore_checkpoint(ckpt_dir, latest, state)
            start_step = int(latest)

    seen = 0
    for epoch in range(num_epochs):
        for batch in data_epochs(epoch):
            if seen < start_step:       # replay-skip on resume
                seen += 1
                continue
            if isinstance(batch, dict):  # offline-features shards
                state, metrics = step_fn(state, params_target, **batch)
            else:
                ids, mask = batch
                state, metrics = step_fn(state, params_target, ids, mask)
            seen += 1
            if logger is not None and seen % log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["epoch"] = epoch
                logger.log(metrics, step=seen)
        if epoch_probe is not None and seen > start_step:
            agg: dict = {}
            nb = 0
            for batch in data_epochs(epoch):
                if nb >= probe_batches:
                    break
                if isinstance(batch, dict):
                    ids, mask = batch["input_ids"], batch["loss_mask"]
                else:
                    ids, mask = batch
                for k, v in epoch_probe(state.params, params_target, ids,
                                        mask).items():
                    agg[k] = agg.get(k, 0.0) + float(v)
                nb += 1
            if nb and logger is not None:
                logger.log({f"eval/{k}": v / nb for k, v in agg.items()}
                           | {"epoch": epoch}, step=seen)
        if (ckpt_dir is not None and (epoch + 1) % save_every_epochs == 0
                and latest_checkpoint_step(ckpt_dir) != state.step):
            # (the latest-step guard skips re-saving during replay-skip
            # epochs after a resume)
            synchronize(state.params.lm_head)
            save_checkpoint(ckpt_dir, state)
    if (ckpt_dir is not None and state.step > start_step
            and latest_checkpoint_step(ckpt_dir) != state.step):
        save_checkpoint(ckpt_dir, state)
    return state
