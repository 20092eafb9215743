"""Carry the reference LM's parameters into the port.

The reference keeps one tree of arrays: ``embed``, ``final_norm`` and
``run{ri}`` -> ``sub{j}`` -> layer params, where a run
repeated ``count > 1`` times is stacked on a leading axis (``vmap``ed
init, scanned apply), and for an encoder-decoder ``encoder`` (its layers
stacked the same way, whatever their count) and ``enc_norm``. The port
holds one module per layer, named ``run{ri}.{c}.sub{j}...`` and
``encoder.{i}...``, with every weight in the reference's own layout
(attention (d, H, hd) / (H, hd, d) and its biases ``bq``/``bk``/``bv``
(H, hd), FFN (in, out) with the GELU MLP's ``b_up``/``b_down``, the MoE's
float32 ``router`` (d, E) and expert stacks (E, in, out), the RG-LRU's
``rec.*`` (projections (in, out), ``conv_w`` (W, C), float32 ``b_a``,
``b_x``, ``lam``), the SSD's ``ssm.*`` (projections (in, out), conv
weights (W, C), float32 ``A_log``, ``D``, ``dt_bias`` and
``ssm.out_norm.scale``), an untied ``lm_head`` (d, vocab), threshold nets
``w`` (in, out)), so conversion only unstacks the runs and the encoder.
Key sets and shapes must match exactly.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from .model import LM


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        elif v is not None:
            out[key] = np.asarray(v)
    return out


def port_params(model: LM, params) -> dict[str, np.ndarray]:
    """The reference tree as the port's dotted parameter names."""
    counts = {f"run{ri}": count for ri, (_, count) in enumerate(model.runs)}
    if model.cfg.encoder_layers:
        counts["encoder"] = model.cfg.encoder_layers
    out = {}
    for key, arr in _flatten(params).items():
        m = re.match(r"(run\d+|encoder)\.(.*)", key)
        if m is None:
            out[key] = arr
            continue
        run, rest = m.groups()
        if run not in counts:
            raise KeyError(f"reference parameter {key} has no run in the port")
        if counts[run] == 1 and run != "encoder":     # the encoder is stacked always
            out[f"{run}.0.{rest}"] = arr
        else:
            if arr.shape[0] != counts[run]:
                raise ValueError(f"{key}: stacked over {arr.shape[0]}, the run has "
                                 f"{counts[run]}")
            for c in range(counts[run]):
                out[f"{run}.{c}.{rest}"] = arr[c]
    return out


def from_jax_params(model: LM, params) -> LM:
    """Copy a reference parameter tree (arrays or numpy) into ``model`` in
    place, each tensor in the port parameter's dtype; returns the model."""
    src = port_params(model, params)
    dst = model.state_dict()
    if set(src) != set(dst):
        raise KeyError(f"parameter names differ: only in the reference "
                       f"{sorted(set(src) - set(dst))}, only in the port "
                       f"{sorted(set(dst) - set(src))}")
    with torch.no_grad():
        for name, t in dst.items():
            a = src[name]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{name}: reference {a.shape} vs port {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(a, dtype=np.float32)).to(t.dtype))
    return model
