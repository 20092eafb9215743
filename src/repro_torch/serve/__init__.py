"""Serving helpers of the port (``repro.serve``): the power-of-two shape
ladder. The continuous-batching engine, its scheduler and the paged KV
pool wait (ROADMAP.md, module queue)."""
from .bucket import pow2_bucket, pow2_ceil  # noqa: F401
