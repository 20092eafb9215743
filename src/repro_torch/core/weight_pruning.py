"""Magnitude weight pruning (Han et al., NeurIPS'15), the unstructured
partner method in Tables II-IV; the port of ``repro.core.weight_pruning``.
Prune the smallest-|w| fraction of every conv / dense weight of a trained
model, then retrain with the mask fixed. The parameters are a dict of
dotted name -> tensor; a weight is a name ending in ``w`` or ``kernel``
with at least two dimensions.
"""
from __future__ import annotations

import torch

from ..utils import quantile

Params = dict[str, torch.Tensor]


def _is_weight(name: str, t: torch.Tensor) -> bool:
    return name.split(".")[-1] in ("w", "kernel") and t.dim() >= 2


def magnitude_masks(params: Params, prune_frac: float, per_layer: bool = True) -> Params:
    """Weight name -> 0/1 keep mask of the weight's shape and dtype. With
    ``per_layer`` each weight keeps the entries above its own
    ``prune_frac`` quantile of |w|; otherwise every weight is cut at one
    global quantile of |w| over all the weights together."""
    weights = {k: w for k, w in params.items() if _is_weight(k, w)}
    if per_layer:
        return {k: (w.abs() > quantile(w.abs().to(torch.float32), prune_frac)).to(w.dtype)
                for k, w in weights.items()}
    thr = quantile(torch.cat([w.abs().reshape(-1).to(torch.float32)
                              for w in weights.values()]), prune_frac)
    return {k: (w.abs() > thr).to(w.dtype) for k, w in weights.items()}


def apply_masks(params: Params, masks: Params) -> Params:
    return {k: (p * masks[k] if k in masks else p) for k, p in params.items()}


def sparsity(masks: Params) -> float:
    tot = sum(m.numel() for m in masks.values())
    kept = sum(float(m.sum()) for m in masks.values())
    return 1.0 - kept / max(tot, 1)
