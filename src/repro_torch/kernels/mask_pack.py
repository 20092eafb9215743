"""The two-phase Zebra streaming producer (``repro.kernels.mask_pack``).

``zebra_mask_pack`` turns a raw ``(M, K)`` activation map into the
compressed ``(payload, bitmap, n_live)`` stream — the bytes the paper's
accelerator puts on DRAM (Eq. 2/3) — without materializing the dense
masked map:

1. **Comparator** (``zebra_bitmap``, CUDA ``zebra_bitmap_kernel``):
   per-``(bs, bc)``-block ``max|x| >= T_obj`` -> int8 keep bitmap. Reads
   only x.
2. **Exclusive scan** (``schedule.slot_map``, ``torch.cumsum``): the
   consumer-order slot of every block, and ``n_live``. Stays on the
   device.
3. **Pack** (``pack_blocks``, CUDA ``zebra_pack_kernel``): each live
   block to its slot, zeros in slots ``[n_live, nb)``.

Each wrapper runs its CUDA kernel for a CUDA tensor (or raises) and its
plain PyTorch version (``*_plain``) for a CPU tensor, and counts its
kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from .build import check_launch, cuda_library, stream_of
from .ref import threshold_as
from .schedule import slot_map

# the map dtypes of the comparator, the masking kernel and pack (the C
# entry points' dtype codes; pack and unpack move bits by item size)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_map(x: torch.Tensor, bs: int, bc: int) -> tuple[int, int]:
    if x.dim() != 2:
        raise ValueError(f"expected a 2-D (M, K) map, got shape {tuple(x.shape)}")
    M, K = x.shape
    if M % bs or K % bc:
        raise ValueError(f"(M={M}, K={K}) must divide by block ({bs},{bc})")
    return M // bs, K // bc


def _check_cuda_map(x: torch.Tensor, kernel: str) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{kernel}: CUDA kernel takes float32, bfloat16 or "
                        f"float16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: CUDA kernel needs a contiguous map")


# ---------------------------------------------------------------------------
# Phase 1: comparator
# ---------------------------------------------------------------------------

def bitmap_plain(x: torch.Tensor, t_obj: float, bs: int, bc: int) -> torch.Tensor:
    """Plain version of ``zebra_bitmap_kernel``: int8 keep bitmap."""
    nm, nk = _check_map(x, bs, bc)
    blockmax = x.reshape(nm, bs, nk, bc).abs().amax(dim=(1, 3))
    return (blockmax >= threshold_as(t_obj, x.dtype)).to(torch.int8)


def bitmap_cuda(x: torch.Tensor, t_obj: float, bs: int, bc: int) -> torch.Tensor:
    lib = cuda_library(x, "zebra_bitmap")
    nm, nk = _check_map(x, bs, bc)
    _check_cuda_map(x, "zebra_bitmap")
    bitmap = torch.empty((nm, nk), dtype=torch.int8, device=x.device)
    rc = lib.zebra_bitmap_launch(x.data_ptr(), bitmap.data_ptr(), x.shape[0],
                                 x.shape[1], bs, bc, threshold_as(t_obj, x.dtype),
                                 _DTYPE_CODES[x.dtype], stream_of(x))
    check_launch(rc, "zebra_bitmap")
    zebra_bitmap.launches += 1
    return bitmap


def zebra_bitmap(x: torch.Tensor, *, t_obj: float, bs: int, bc: int) -> torch.Tensor:
    """Keep bitmap ``(M//bs, K//bc)`` int8 of an (M, K) map: block max|x|
    >= ``t_obj`` in the map's dtype; a block holding NaN is dead."""
    if x.device.type == "cpu":
        return bitmap_plain(x, t_obj, bs, bc)
    return bitmap_cuda(x, t_obj, bs, bc)


zebra_bitmap.launches = 0


# ---------------------------------------------------------------------------
# Phase 2b: pack
# ---------------------------------------------------------------------------

def pack_plain(x: torch.Tensor, bitmap: torch.Tensor, slot: torch.Tensor,
               n_live: torch.Tensor, bs: int, bc: int) -> torch.Tensor:
    """Plain version of ``zebra_pack_kernel``: every live block copied to
    its slot; the slots past ``n_live`` are never written and stay zero."""
    nm, nk = bitmap.shape
    nb = nm * nk
    blocks = x.reshape(nm, bs, nk, bc).permute(0, 2, 1, 3).reshape(nb, bs, bc)
    # dead blocks all land in the scratch row nb, which is cut off
    dest = torch.where(bitmap.reshape(-1) != 0, slot.to(torch.int64),
                       torch.full((), nb, dtype=torch.int64, device=x.device))
    payload = x.new_zeros((nb + 1, bs, bc))
    payload.index_copy_(0, dest, blocks)
    return payload[:nb]


def pack_launch(x: torch.Tensor, bitmap: torch.Tensor, slot: torch.Tensor,
                n_live: torch.Tensor, bs: int, bc: int, kernel: str) -> torch.Tensor:
    """One launch of ``zebra_pack_kernel``, counted by the caller (the
    producer's ``pack_blocks`` and the codec's ``pack.zebra_pack`` keep a
    count each)."""
    lib = cuda_library(x, kernel)
    nm, nk = _check_map(x, bs, bc)
    _check_cuda_map(x, kernel)
    if (bitmap.dtype != torch.int8 or tuple(bitmap.shape) != (nm, nk)
            or slot.dtype != torch.int32 or slot.numel() != nm * nk
            or n_live.dtype != torch.int32 or n_live.numel() != 1):
        raise ValueError(f"{kernel}: expected an int8 (nm, nk) bitmap, an "
                         "int32 slot map of nm*nk entries and an int32 n_live")
    bitmap, slot = bitmap.contiguous(), slot.contiguous()
    payload = torch.empty((nm * nk, bs, bc), dtype=x.dtype, device=x.device)
    rc = lib.zebra_pack_launch(x.data_ptr(), bitmap.data_ptr(), slot.data_ptr(),
                               n_live.data_ptr(), payload.data_ptr(),
                               x.shape[0], x.shape[1], bs, bc,
                               x.element_size(), stream_of(x))
    check_launch(rc, kernel)
    return payload


def pack_cuda(x: torch.Tensor, bitmap: torch.Tensor, slot: torch.Tensor,
              n_live: torch.Tensor, bs: int, bc: int) -> torch.Tensor:
    payload = pack_launch(x, bitmap, slot, n_live, bs, bc, "zebra_pack")
    pack_blocks.launches += 1
    return payload


def pack_blocks(x: torch.Tensor, bitmap: torch.Tensor, slot: torch.Tensor,
                n_live: torch.Tensor, *, bs: int, bc: int) -> torch.Tensor:
    """Payload ``(nb, bs, bc)``: live blocks of x at their consumer-order
    slots, exact zeros in slots ``[n_live, nb)``."""
    if x.device.type == "cpu":
        return pack_plain(x, bitmap, slot, n_live, bs, bc)
    return pack_cuda(x, bitmap, slot, n_live, bs, bc)


pack_blocks.launches = 0


# ---------------------------------------------------------------------------
# The producer
# ---------------------------------------------------------------------------

def zebra_mask_pack(x: torch.Tensor, *, t_obj: float, bs: int = 8, bc: int = 128
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Comparator + compaction over an (M, K) map in two kernel launches.

    Returns ``(payload (n_blocks, bs, bc) — live blocks first in consumer
    order, zero tail; bitmap (M//bs, K//bc) int8; n_live () int32)``, all
    on x's device (``n_live`` is never read back here)."""
    payload, bitmap, n_live, _, _ = mask_pack_with_slots(x, t_obj=t_obj, bs=bs, bc=bc)
    return payload, bitmap, n_live


def mask_pack_with_slots(x: torch.Tensor, *, t_obj: float, bs: int, bc: int):
    """``zebra_mask_pack`` that also returns the scan's ``(keep, slot)``,
    so an expander on the same stream need not scan the bitmap again."""
    _check_map(x, bs, bc)
    bitmap = zebra_bitmap(x, t_obj=t_obj, bs=bs, bc=bc)
    keep, slot = slot_map(bitmap)
    n_live = keep.sum(dtype=torch.int32)
    payload = pack_blocks(x, bitmap, slot, n_live, bs=bs, bc=bc)
    return payload, bitmap, n_live, keep, slot
