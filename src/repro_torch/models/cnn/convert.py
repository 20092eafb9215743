"""Carry a reference CNN's variables into a port module.

The reference keeps ``{"params", "state", "zebra"}`` trees of arrays; the
port keeps one ``nn.Module`` whose parameter and buffer names mirror those
trees. Conversion is a flatten into dotted names, with two layout rules:

* conv weights are OIHW on both sides and copy as they are;
* dense weights ``fc.w`` are (in, out) in the reference and (out, in) in
  torch, so they are transposed.

BatchNorm ``mean``/``var`` (the reference's ``state``) land in buffers;
threshold nets ``z{i}`` land in ``model.zebra`` although inference does
not read them. The key sets and shapes must match exactly.
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


def from_jax_variables(model: nn.Module, variables_np) -> nn.Module:
    """Load the reference's variable tree (numpy arrays, or anything
    ``np.asarray`` takes) into ``model`` in place; returns the model."""
    flat = _flatten(variables_np.get("params", {}))
    flat.update(_flatten(variables_np.get("state", {})))
    flat.update(_flatten(variables_np.get("zebra") or {}, "zebra."))
    own = model.state_dict()
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise ValueError(f"variable trees differ: missing {missing}, "
                         f"unexpected {extra}")
    new = {}
    for key, ref in own.items():
        arr = flat[key].T if key in _DENSE_WEIGHTS else flat[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: shape {arr.shape} vs module {tuple(ref.shape)}")
        new[key] = torch.from_numpy(np.array(arr, copy=True)).to(ref.dtype)
    model.load_state_dict(new)
    return model
