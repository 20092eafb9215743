"""Continuous-batching serving over a paged compressed-KV pool
(``repro.serve``):

- :mod:`~repro_torch.serve.bucket`: power-of-two shape ladders (the
  bounded-shape contract shared by both serve paths);
- :mod:`~repro_torch.serve.scheduler`: host-side admission, preemption and
  retirement policy over plain :class:`Request` records;
- :mod:`~repro_torch.serve.pool`: the paged store of compressed KV payload
  slabs (page in and out in ``(bitmap, payload)`` stream form, per-page
  Eq. 2/3 metering and ingest validation);
- :mod:`~repro_torch.serve.engine`: the slotted decode loop tying them
  together (``launch.serve --requests`` is a thin CLI over it).
"""
from .bucket import bucket_ladder, pow2_bucket, pow2_ceil, pow2_floor
from .engine import ServeEngine
from .pool import PagedKVPool
from .scheduler import Request, Scheduler, synthetic_trace

__all__ = ["ServeEngine", "PagedKVPool", "Request", "Scheduler",
           "synthetic_trace", "pow2_bucket", "pow2_ceil", "pow2_floor",
           "bucket_ladder"]
