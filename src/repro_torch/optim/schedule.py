"""LR schedules (``repro.optim.schedule``). Paper: "standard SGD with
learning rate step decay from 0.1 to 0.001".

A schedule maps the integer step to the learning rate, computed on the
host in float32 as the reference computes it on the device, and returned
as a Python float that holds that float32 value exactly."""
from __future__ import annotations

import numpy as np

f32 = np.float32


def constant(lr: float):
    return lambda step: float(f32(lr))


def step_decay(base_lr: float = 0.1, boundaries=(0.5, 0.75), total_steps: int = 1000,
               factor: float = 0.1):
    """0.1 -> 0.01 -> 0.001 at the given fraction boundaries (paper setting)."""
    bs = [int(b * total_steps) for b in boundaries]

    def fn(step: int) -> float:
        lr = f32(base_lr)
        for b in bs:
            if step >= b:
                lr = lr * f32(factor)
        return float(lr)
    return fn


def cosine(base_lr: float, total_steps: int, min_frac: float = 0.0):
    def fn(step: int) -> float:
        t = np.clip(f32(step) / f32(max(total_steps, 1)), f32(0.0), f32(1.0))
        return float(f32(base_lr) * (f32(min_frac) + f32(1 - min_frac) * f32(0.5)
                                     * (f32(1) + np.cos(f32(np.pi) * t))))
    return fn


def warmup_cosine(base_lr: float, warmup: int, total_steps: int, min_frac: float = 0.1):
    cos = cosine(base_lr, max(total_steps - warmup, 1), min_frac)

    def fn(step: int) -> float:
        if step < warmup:
            w = np.clip(f32(step) / f32(max(warmup, 1)), f32(0.0), f32(1.0))
            return float(f32(base_lr) * w)
        return cos(step - warmup)
    return fn
