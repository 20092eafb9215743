"""Power-of-two shape bucketing for the serving paths (a copy of
``repro.serve.bucket``).

Admission-time variability (prompt lengths, in-flight counts, cache
growth) is quantized onto these ladders, so the set of shapes a server
allocates and dispatches is computable up front and asserted, not
observed (``serve/engine.py`` raises on any shape outside its declared
ladder).
"""
from __future__ import annotations


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    n = int(n)
    if n < 1:
        raise ValueError(f"pow2_ceil needs n >= 1, got {n}")
    return 1 << (n - 1).bit_length()


def pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    n = int(n)
    if n < 1:
        raise ValueError(f"pow2_floor needs n >= 1, got {n}")
    return 1 << (n.bit_length() - 1)


def pow2_bucket(n: int, lo: int = 8, hi: int | None = None) -> int:
    """Quantize ``n`` up to the power-of-two ladder clamped at ``lo``. With
    ``hi``, values above the ladder top are an error: the caller must
    reject (serve) or split (paging) instead of growing the shape set."""
    b = max(pow2_ceil(max(n, 1)), pow2_ceil(lo))
    if hi is not None:
        top = pow2_ceil(hi)
        if b > top:
            raise ValueError(f"{n} exceeds the bucket ladder top {top}")
    return b


def bucket_ladder(lo: int, hi: int) -> tuple[int, ...]:
    """Every bucket ``pow2_bucket(·, lo, hi)`` can return: the ladder
    [pow2_ceil(lo) .. pow2_ceil(hi)]."""
    b = pow2_ceil(lo)
    out = [b]
    while b < pow2_ceil(hi):
        b *= 2
        out.append(b)
    return tuple(out)
