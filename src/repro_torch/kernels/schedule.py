"""The consumer-order slot map of the Zebra payload (``repro.kernels.schedule``).

Payload order contract: payload slots are grouped by K-block **column**,
columns ascending, live blocks ascending by block row within each column,
all live slots contiguous in ``[0, n_live)``, zero tail after. With
``keep`` the (nm, nk) bitmap::

    counts[k]  = sum_r keep[r, k]            live blocks in column k
    offsets[k] = sum_{k' < k} counts[k']     column k's first payload slot
    slot[r, k] = offsets[k] + |{r' < r : keep[r', k]}|

The slot is the exclusive prefix sum of the keep flags taken in
column-major order, one ``torch.cumsum`` between the producer's two kernel
launches, as the reference runs its scan in XLA between its two Pallas
passes. It stays on the device: nothing here reads a value back.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class PrefetchSchedule(NamedTuple):
    """Every array is a pure function of the bitmap's prefix sums.

    keep     (nm, nk) int32 keep flags
    counts   (nk,)    live blocks per K-block column
    offsets  (nk,)    exclusive prefix sum of counts
    slot     (nm, nk) block -> payload slot (consumer order)
    rows     (nk, nm) fetch plan: rows[k, i] = block row of the i-th live
                      block in column k; ``nm`` pads past counts[k]
    """
    keep: torch.Tensor
    counts: torch.Tensor
    offsets: torch.Tensor
    slot: torch.Tensor
    rows: torch.Tensor


def _slots(bitmap: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 keep flags and slots, both (nm, nk). ``offsets[k] +
    colrank[r, k]`` is the exclusive prefix sum of keep in column-major
    order, so one ``torch.cumsum`` over the transposed flags computes it.
    (A cumsum down dim 0 of the (nm, nk) bitmap scans each of the nk
    columns serially on the card, and cost ~5 ms per call at nm = 65536.)"""
    nm, nk = bitmap.shape
    keep = bitmap.to(torch.int32)
    kt = keep.t().reshape(-1)
    slot = (torch.cumsum(kt, 0, dtype=torch.int32) - kt).view(nk, nm).t()
    return keep, slot


def consumer_schedule(bitmap: torch.Tensor) -> PrefetchSchedule:
    """Build the prefetch schedule from the bitmap prefix sums."""
    nm, nk = bitmap.shape
    dev = bitmap.device
    keep, slot = _slots(bitmap)
    counts = keep.sum(dim=0, dtype=torch.int32)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    colrank = slot - offsets[None, :]
    # scatter each live block's row into its column rank; dead blocks aim
    # at the pad column nm, which is cut off afterwards
    kk = torch.arange(nk, device=dev).expand(nm, nk)
    rr = torch.arange(nm, dtype=torch.int32, device=dev)[:, None].expand(nm, nk)
    ctgt = torch.where(keep != 0, colrank.to(torch.int64),
                       torch.full((), nm, dtype=torch.int64, device=dev))
    rows = torch.full((nk, nm + 1), nm, dtype=torch.int32, device=dev)
    rows[kk.reshape(-1), ctgt.reshape(-1)] = rr.reshape(-1)
    return PrefetchSchedule(keep=keep, counts=counts, offsets=offsets,
                            slot=slot.contiguous(), rows=rows[:, :nm].contiguous())


def slot_map(bitmap: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat (row-major block index g = r*nk + k) int32 keep flags and the
    consumer-order block -> payload-slot map, the one map the pack and
    unpack kernels address the payload through.

    A dead block's slot aliases the next live slot of its column, so every
    value is <= n_live <= nb - 1 whenever a dead block exists."""
    keep, slot = _slots(bitmap)
    return keep.reshape(-1), slot.reshape(-1)
