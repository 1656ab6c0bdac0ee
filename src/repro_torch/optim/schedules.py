"""Learning-rate schedules as step -> lr callables.

The step is a host integer and the rate a Python float, so a schedule
costs no device work. The arithmetic is float32, as in the reference.
"""

from __future__ import annotations

import numpy as np

_f32 = np.float32


def constant(lr):
    return lambda step: float(_f32(lr))


def linear_anneal(lr, total_steps, warmup_steps=0):
    """IMPALA default: linear anneal to 0 over total_steps."""
    def f(step):
        step = _f32(step)
        warm = min(step / _f32(max(warmup_steps, 1)), _f32(1.0)) \
            if warmup_steps > 0 else _f32(1.0)
        frac = np.clip(_f32(1.0) - step / _f32(total_steps), 0.0, 1.0)
        return float(_f32(lr) * warm * _f32(frac))
    return f


def cosine(lr, total_steps, warmup_steps=0, min_ratio=0.1):
    def f(step):
        step = _f32(step)
        warm = min(step / _f32(max(warmup_steps, 1)), _f32(1.0)) \
            if warmup_steps else _f32(1.0)
        t = np.clip((step - _f32(warmup_steps))
                    / _f32(max(total_steps - warmup_steps, 1)), 0.0, 1.0)
        cos = _f32(min_ratio) + _f32(1 - min_ratio) * _f32(0.5) * (
            _f32(1.0) + np.cos(_f32(np.pi) * _f32(t)))
        return float(_f32(lr) * warm * _f32(cos))
    return f


def make_schedule(train_cfg):
    if train_cfg.lr_schedule == "linear":
        return linear_anneal(train_cfg.learning_rate, train_cfg.total_steps,
                             train_cfg.warmup_steps)
    if train_cfg.lr_schedule == "cosine":
        return cosine(train_cfg.learning_rate, train_cfg.total_steps,
                      train_cfg.warmup_steps)
    if train_cfg.lr_schedule == "constant":
        return constant(train_cfg.learning_rate)
    raise ValueError(train_cfg.lr_schedule)
