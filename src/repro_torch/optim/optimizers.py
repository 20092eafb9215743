"""Optimizers (``repro.optim.optimizers``) as plain functions over the
trainable tensors: parameters, gradients and optimizer state are dicts of
name -> tensor, and ``update`` returns new tensors without changing its
inputs.

The paper trains with "standard SGD optimizer with learning rate step
decay from 0.1 to 0.001" and weight decay; the LM side uses AdamW. Weight
decay applies to every trainable tensor (BatchNorm scale and bias and the
threshold nets included), as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..utils import global_norm

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], dict]
    update: Callable[..., tuple[Params, dict]]     # (grads, state, params, step)


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


def clip_by_global_norm(grads: Params, max_norm: float) -> tuple[Params, torch.Tensor]:
    norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm


def _zeros_f32(params: Params) -> Params:
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}


def sgd(lr_fn: Callable[[int], float], momentum: float = 0.9,
        weight_decay: float = 5e-4, nesterov: bool = False) -> Optimizer:
    def init(params: Params) -> dict:
        return {"mu": _zeros_f32(params)}

    def update(grads: Params, state: dict, params: Params, step: int):
        lr = lr_fn(step)
        updates, mu = {}, {}
        for k, p in params.items():
            g = grads[k].to(torch.float32) + weight_decay * p.to(torch.float32)
            mu[k] = momentum * state["mu"][k] + g
            d = g + momentum * mu[k] if nesterov else mu[k]
            updates[k] = -lr * d
        return updates, {"mu": mu}

    return Optimizer(init, update)


def adamw(lr_fn: Callable[[int], float], b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params: Params) -> dict:
        return {"m": _zeros_f32(params), "v": _zeros_f32(params)}

    def update(grads: Params, state: dict, params: Params, step: int):
        lr = lr_fn(step)
        # bias corrections in float32, as the reference computes them
        t = np.float32(step) + np.float32(1.0)
        c1 = float(np.float32(1.0) - np.power(np.float32(b1), t))
        c2 = float(np.float32(1.0) - np.power(np.float32(b2), t))
        updates, m, v = {}, {}, {}
        for k, p in params.items():
            g = grads[k].to(torch.float32)
            m[k] = b1 * state["m"][k] + (1 - b1) * g
            v[k] = b2 * state["v"][k] + (1 - b2) * torch.square(g)
            upd = m[k] / c1 / (torch.sqrt(v[k] / c2) + eps)
            updates[k] = -lr * (upd + weight_decay * p.to(torch.float32))
        return updates, {"m": m, "v": v}

    return Optimizer(init, update)
