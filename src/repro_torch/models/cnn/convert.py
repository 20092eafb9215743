"""Carry a reference CNN's variables, or its whole trainer state, into the
port.

The reference keeps ``{"params", "state", "zebra"}`` trees of arrays; the
port keeps one ``nn.Module`` whose parameter and buffer names mirror those
trees. Conversion is a flatten into dotted names, with two layout rules:

* conv weights are OIHW on both sides and copy as they are;
* dense weights ``fc.w`` are (in, out) in the reference and (out, in) in
  torch, so they are transposed.

BatchNorm ``mean``/``var`` (the reference's ``state``) land in buffers;
threshold nets ``z{i}`` land in ``model.zebra``. The key sets and shapes
must match exactly.

A trainer state ``{"variables", "opt", "step"}`` carries across too: each
optimizer slot (``mu`` for SGD, ``m`` and ``v`` for AdamW) mirrors the
reference's trainable tree ``{"params", "zebra"}`` and flattens by the same
rules, and ``step`` becomes a Python int, so a reference-trained state
continues in ``CNNTrainer``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

_DENSE_WEIGHTS = ("fc.w",)


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        elif v is not None:
            out[key] = np.asarray(v)
    return out


def _to_port(flat: dict[str, np.ndarray], own: Mapping[str, torch.Tensor],
             what: str) -> dict[str, torch.Tensor]:
    """Match a flattened reference tree against the port's tensors by name
    and shape; returns tensors of the port's dtype on its device."""
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise ValueError(f"{what}: trees differ: missing {missing}, "
                         f"unexpected {extra}")
    new = {}
    for key, ref in own.items():
        arr = flat[key].T if key in _DENSE_WEIGHTS else flat[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{what}: {key}: shape {arr.shape} vs port "
                             f"{tuple(ref.shape)}")
        new[key] = torch.from_numpy(np.array(arr, copy=True)).to(ref.dtype).to(ref.device)
    return new


def _flatten_trainable(tree) -> dict[str, np.ndarray]:
    flat = _flatten(tree.get("params", {}))
    flat.update(_flatten(tree.get("zebra") or {}, "zebra."))
    return flat


def from_jax_variables(model: nn.Module, variables_np) -> nn.Module:
    """Load the reference's variable tree (numpy arrays, or anything
    ``np.asarray`` takes) into ``model`` in place; returns the model."""
    flat = _flatten_trainable(variables_np)
    flat.update(_flatten(variables_np.get("state", {})))
    model.load_state_dict(_to_port(flat, model.state_dict(), "variables"))
    return model


def from_jax_state(model: nn.Module, state_np) -> dict:
    """The reference trainer's state ``{"variables", "opt", "step"}`` as the
    port's ``CNNTrainer`` state. The variables are also loaded into
    ``model``; the optimizer slots land on the device of its parameters."""
    from_jax_variables(model, state_np["variables"])
    params = dict(model.named_parameters())
    opt = {slot: _to_port(_flatten_trainable(tree), params, f"opt[{slot!r}]")
           for slot, tree in state_np["opt"].items()}
    return {"variables": {k: v.clone() for k, v in model.state_dict().items()},
            "opt": opt, "step": int(state_np["step"])}
