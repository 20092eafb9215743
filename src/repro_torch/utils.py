"""Shape math, tensor-collection and formatting helpers shared by the port
(``repro.utils`` keeps the rest)."""
from __future__ import annotations

import contextlib
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


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} PiB"


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card: with no ``device`` given, a host
    without CUDA raises rather than run on the CPU. The CPU must be asked
    for (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available: repro_torch runs on "
                               "the card; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def float32_sums(device: torch.device):
    """Inside the block, on the card: a 16-bit GEMM's sums kept in float32
    until its one rounding (cuBLAS's reduced-precision split-K reduction
    off), as the reference sums them. A tensor-parallel rank's row-parallel
    products round once (``distributed.ctx.row_parallel``); its other GEMMs,
    and those of the single-process run it is held against, then round as
    one process's float32 sums do, so a block near T_obj flips on neither
    side. The settings in force before come back on exit; nothing on the
    CPU."""
    m = torch.backends.cuda.matmul
    old = (m.allow_bf16_reduced_precision_reduction,
           m.allow_fp16_reduced_precision_reduction)
    if device.type == "cuda":
        m.allow_bf16_reduced_precision_reduction = False
        m.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (m.allow_bf16_reduced_precision_reduction,
         m.allow_fp16_reduced_precision_reduction) = old


def map_tree(fn, tree, path=()):
    """Apply ``fn(path, leaf)`` to every leaf of nested dicts, lists and
    tuples in the reference's pytree order (dict keys sorted), keeping the
    structure; None stays None. ``path`` holds the dict keys and list
    indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], path + (k,)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, path + (i,)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)
