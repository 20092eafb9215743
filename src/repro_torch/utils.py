"""Shape math and tensor-collection helpers shared by the port
(``repro.utils`` keeps the rest)."""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ ||t||²) over the tensors, in float32."""
    return torch.sqrt(torch.stack([t.to(torch.float32).square().sum()
                                   for t in tensors]).sum())


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` over all elements of a float32 tensor (NaN if
    any element is NaN): the linear interpolation ``lo·(1 − w) + hi·w`` in
    float32, with ``hi·w`` added unrounded as XLA's fused multiply-add does.
    Selects with ``torch.kthvalue`` instead of calling ``torch.quantile``,
    which refuses inputs of more than 2**24 elements."""
    a = x.reshape(-1)
    n = a.numel()
    pos = np.float32(q) * (np.float32(n) - np.float32(1))    # float32, as jnp
    low, high = int(np.floor(pos)), int(np.ceil(pos))
    high_w = np.float32(pos - np.float32(low))
    lo = torch.kthvalue(a, min(max(low, 0), n - 1) + 1).values
    hi = torch.kthvalue(a, min(max(high, 0), n - 1) + 1).values
    # hi·w of two float32 values is exact in float64: one rounding, like an FMA
    out = (hi.double() * float(high_w) + (lo * float(np.float32(1) - high_w)).double()).float()
    return torch.where(torch.isnan(a).any(), torch.full_like(out, float("nan")), out)
