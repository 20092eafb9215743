"""Optimizers (``repro.optim.optimizers``) as plain functions over the
trainable tensors: parameters, gradients and optimizer state are dicts of
name -> tensor. ``update`` returns new tensors without changing its
inputs; ``update_`` writes the new parameters and state into the tensors
it is given, one tensor at a time, so a model of billions of parameters
holds no second copy of them. Both run the same per-tensor arithmetic, in
the same roundings (each product and sum rounded on its own, as the
reference computes them), so their results are equal bit for bit.

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
    update_: Callable[..., None]                    # the same, in place


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads: Params, max_norm: float) -> tuple[Params, torch.Tensor]:
    norm = global_norm(grads.values())
    scale = _clip_scale(norm, max_norm)
    return {k: g * scale for k, g in grads.items()}, norm


@torch.no_grad()
def clip_by_global_norm_(grads: Params, max_norm: float,
                         norm: torch.Tensor | None = None) -> torch.Tensor:
    """``clip_by_global_norm`` scaling the gradients in place; returns the
    norm before clipping. ``norm``: the global norm when it is not that of
    ``grads`` alone (a rank's shards: :func:`sharded_global_norm`)."""
    if norm is None:
        norm = global_norm(grads.values())
    scale = _clip_scale(norm, max_norm)
    for g in grads.values():
        g.mul_(scale)
    return norm


@torch.no_grad()
def sharded_global_norm(grads: Params, owned, all_sum) -> torch.Tensor:
    """The global norm of a gradient held as shards across ranks, each
    element counted once: this rank's sum of squares over the leaves it
    ``owned`` (a leaf whole over some axis belongs to that axis's first
    rank), summed over the ranks by ``all_sum``, then the square root."""
    sq = [g.to(torch.float32).square().sum() for n, g in grads.items() if n in owned]
    local = torch.stack(sq).sum() if sq else torch.zeros(
        (), dtype=torch.float32, device=next(iter(grads.values())).device)
    return torch.sqrt(all_sum(local))


def _zeros_f32(params: Params) -> Params:
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}


def _in_place(rule, state_keys):
    """``update_`` from ``rule(step)``, which returns the per-tensor update
    ``one(g, bufs, p)``: it updates the state buffers ``bufs`` in place and
    returns the tensor's update."""
    @torch.no_grad()
    def update_(grads: Params, state: dict, params: Params, step: int) -> None:
        one = rule(step)
        for k, p in params.items():
            u = one(grads[k], [state[s][k] for s in state_keys], p)
            p.add_(u.to(p.dtype))
            del u
    return update_


def _functional(rule, state_keys):
    """``update`` from the same rule, on copies of the state buffers."""
    def update(grads: Params, state: dict, params: Params, step: int):
        one = rule(step)
        new = {s: {} for s in state_keys}
        updates = {}
        for k, p in params.items():
            bufs = [state[s][k].clone() for s in state_keys]
            updates[k] = one(grads[k], bufs, p)
            for s, b in zip(state_keys, bufs):
                new[s][k] = b
        return updates, new
    return update


def sgd(lr_fn: Callable[[int], float], momentum: float = 0.9,
        weight_decay: float = 5e-4, nesterov: bool = False) -> Optimizer:
    def init(params: Params) -> dict:
        return {"mu": _zeros_f32(params)}

    def rule(step: int):
        lr = lr_fn(step)

        def one(g, bufs, p):
            (mu,) = bufs
            g = g.to(torch.float32) + weight_decay * p.to(torch.float32)
            mu.mul_(momentum).add_(g)                       # momentum * mu + g
            d = g.add_(momentum * mu) if nesterov else mu
            return -lr * d
        return one

    return Optimizer(init, _functional(rule, ("mu",)), _in_place(rule, ("mu",)))


def adamw(lr_fn: Callable[[int], float], b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params: Params) -> dict:
        return {"m": _zeros_f32(params), "v": _zeros_f32(params)}

    def rule(step: int):
        lr = lr_fn(step)
        # bias corrections in float32, as the reference computes them
        t = np.float32(step) + np.float32(1.0)
        c1 = float(np.float32(1.0) - np.power(np.float32(b1), t))
        c2 = float(np.float32(1.0) - np.power(np.float32(b2), t))

        def one(g, bufs, p):
            m, v = bufs
            g = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g)                   # b1 * m + (1 - b1) * g
            v.mul_(b2).add_(torch.square(g).mul_(1 - b2))   # b2 * v + (1 - b2) * g²
            upd = m / c1
            upd.div_(torch.sqrt(v / c2).add_(eps))          # m / c1 / (sqrt(v / c2) + eps)
            upd.add_(weight_decay * p.to(torch.float32))
            return upd.mul_(-lr)                            # -lr * (upd + wd * p)
        return one

    return Optimizer(init, _functional(rule, ("m", "v")), _in_place(rule, ("m", "v")))
