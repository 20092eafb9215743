"""Network Slimming (Liu et al., ICCV'17), the structured-pruning partner
method the paper composes Zebra with (Tables II-IV); the port of
``repro.core.slimming``.

1. *Sparsity training*: add ``rho * Σ|γ|`` over every BatchNorm scale γ to
   the loss.
2. *Slim*: rank all γ globally by magnitude and zero the channels whose γ
   falls in the bottom ``prune_frac`` quantile.
3. *Retrain* with the masks fixed (here: together with Zebra).

Channels are pruned by masking γ and β, not by reshaping weights. The
parameters are a dict of dotted name -> tensor (``"s0b0.bn1.scale"``); a
BatchNorm scale is a name with a component starting with ``bn`` and the
last component ``scale``.
"""
from __future__ import annotations

import torch

from ..utils import quantile

Params = dict[str, torch.Tensor]


def _is_gamma(name: str) -> bool:
    parts = name.split(".")
    return any(p.startswith("bn") for p in parts) and parts[-1] == "scale"


def gamma_l1(params: Params) -> torch.Tensor:
    """Σ |γ| over every BatchNorm scale in ``params``."""
    return sum((params[k].to(torch.float32).abs().sum() for k in params if _is_gamma(k)),
               torch.zeros((), dtype=torch.float32))


def collect_gammas(params: Params) -> dict[str, torch.Tensor]:
    return {k: v for k, v in params.items() if _is_gamma(k)}


def global_threshold(params: Params, prune_frac: float) -> float:
    """Magnitude cut so that ``prune_frac`` of all BN channels fall below it."""
    gammas = collect_gammas(params)
    if not gammas:
        return 0.0
    allg = torch.cat([g.reshape(-1).abs().to(torch.float32) for g in gammas.values()])
    return float(quantile(allg, prune_frac))


def channel_masks(params: Params, prune_frac: float) -> dict[str, torch.Tensor]:
    """BN scale name -> keep mask (1.0 keep / 0.0 prune)."""
    thr = global_threshold(params, prune_frac)
    return {k: (g.abs() > thr).to(torch.float32) for k, g in collect_gammas(params).items()}


def apply_masks(params: Params, masks: dict[str, torch.Tensor]) -> Params:
    """Multiply γ and β of pruned channels by 0 (channel output ≡ BN bias 0)."""
    out = dict(params)
    for name, m in masks.items():
        out[name] = params[name] * m.to(params[name].dtype)
        bias = name[:-len("scale")] + "bias"
        if bias in params:
            out[bias] = params[bias] * m.to(params[bias].dtype)
    return out


def pruned_channel_frac(masks: dict[str, torch.Tensor]) -> float:
    tot = sum(m.numel() for m in masks.values())
    kept = sum(float(m.sum()) for m in masks.values())
    return 1.0 - kept / max(tot, 1)
