"""Learning-rate schedule and batch-size autoscaling.  Port of
``yolact_tpu/train/schedule.py``.

Reference semantics:
  * warmup: lr ramps linearly from ``lr_warmup_init`` to ``lr`` over
    ``lr_warmup_until`` iters (``train.py:293-296``);
  * step decay: multiply by ``gamma`` at each entry of ``lr_steps``
    (``train.py:298-301``);
  * batch-size autoscaling: lr and iteration counts scale by
    ``batch_size / 8`` (``train.py:91-98``).
"""

from __future__ import annotations

import numpy as np

from yolact_tpu_torch.config import YolactConfig


def scale_config_for_batch(cfg: YolactConfig, batch_size: int) -> YolactConfig:
    """lr/max_iter/lr_steps autoscaling (train.py:91-98).  No-op at batch 8."""
    factor = batch_size / 8.0
    if factor == 1.0:
        return cfg
    return cfg.copy(
        lr=cfg.lr * factor,
        max_iter=int(cfg.max_iter / factor),
        lr_steps=tuple(int(s / factor) for s in cfg.lr_steps))


def learning_rate(cfg: YolactConfig, step: int) -> float:
    """lr at `step`, in float32 arithmetic as the JAX package computes it.
    The step count is the host's, so this is a plain number."""
    f32 = np.float32
    step = f32(step)
    n_decays = sum(int(step >= s) for s in cfg.lr_steps)
    lr = f32(cfg.lr) * f32(cfg.gamma ** n_decays)
    # warmup overrides while active
    if cfg.lr_warmup_until > 0 and step < cfg.lr_warmup_until:
        lr = f32(cfg.lr - cfg.lr_warmup_init) \
            * (step / f32(cfg.lr_warmup_until)) + f32(cfg.lr_warmup_init)
    return float(lr)


def apply_delayed_settings(cfg: YolactConfig, iteration: int) -> YolactConfig:
    """Mid-run config mutations (train.py:279-292), applied functionally:
    returns the config with every delayed setting whose iteration has passed
    folded in, and those entries consumed, so a later call returns the
    config unchanged (the same object)."""
    changes = {}
    remaining = []
    for it, kv in cfg.delayed_settings:
        if iteration >= it:
            changes.update(dict(kv))
        else:
            remaining.append((it, kv))
    if not changes:
        return cfg
    return cfg.copy(delayed_settings=tuple(remaining), **changes)
