"""Power-of-two shape bucketing for the serving paths (a copy of
``repro.serve.bucket``).

Serve-side shape choices (cache lengths, prompt lengths) go through these
helpers so the set of shapes a server allocates is computable up front.
"""
from __future__ import annotations


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    n = int(n)
    if n < 1:
        raise ValueError(f"pow2_ceil needs n >= 1, got {n}")
    return 1 << (n - 1).bit_length()


def pow2_bucket(n: int, lo: int = 8) -> int:
    """Quantize ``n`` up to the power-of-two ladder clamped at ``lo``."""
    return max(pow2_ceil(max(n, 1)), pow2_ceil(lo))
