"""Compressed activation transport: pack and unpack (``repro.kernels.pack``).

``zebra_pack`` compacts the live ``(bs, bc)`` blocks of an already-masked
``(M, K)`` map under a bitmap given from outside (the codec's lossless
nonzero-block bitmap, say) into the consumer-order payload, zero tail. It
replaces the Pallas ``_pack_kernel``: the scan ``schedule.slot_map`` and
then the producer's pack kernel ``zebra_pack_kernel``
(``csrc/zebra_stream.cu``), whose launches this entry counts in
``zebra_pack.launches``.

``zebra_unpack`` is the inverse: the consumer-order payload ``(n_blocks,
bs, bc)`` and the keep bitmap back to the dense ``(M, K)`` map, dead
blocks as exact +0. For a CUDA tensor it launches ``zebra_unpack_kernel``
and counts the launch in ``zebra_unpack.launches``.

For a CPU tensor each runs its plain version (``mask_pack.pack_plain``,
``expand_payload``).
"""
from __future__ import annotations

import torch

from .build import check_launch, cuda_library, stream_of
from .mask_pack import _check_map, pack_launch, pack_plain
from .schedule import slot_map


def zebra_pack(x: torch.Tensor, bitmap: torch.Tensor, *, bs: int = 8,
               bc: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact the live blocks of a masked (M, K) map under ``bitmap``
    ``(M//bs, K//bc)``: returns (payload ``(n_blocks, bs, bc)``, live blocks
    first in consumer order, zero tail; ``n_live`` () int32)."""
    nm, nk = _check_map(x, bs, bc)
    if tuple(bitmap.shape) != (nm, nk):
        raise ValueError(f"bitmap {tuple(bitmap.shape)} != {(nm, nk)}")
    bitmap = (bitmap != 0).to(torch.int8)
    keep, slot = slot_map(bitmap)
    n_live = keep.sum(dtype=torch.int32)
    if x.device.type == "cpu":
        return pack_plain(x, bitmap, slot, n_live, bs, bc), n_live
    payload = pack_launch(x.contiguous(), bitmap, slot, n_live, bs, bc, "zebra_pack")
    zebra_pack.launches += 1
    return payload, n_live


zebra_pack.launches = 0


def expand_payload(payload: torch.Tensor, keep: torch.Tensor, smap: torch.Tensor,
                   nm: int, nk: int, bs: int, bc: int) -> torch.Tensor:
    """Plain blocked expansion of a compressed stream to the dense (M, K)
    map — the plain version of ``zebra_unpack_kernel``.

    ``torch.where``, not multiplication: a dead block's slot aliases a
    live block, and masking by * would leak NaN/Inf (and -0.0) from it."""
    blocks = torch.where((keep != 0)[:, None, None], payload[smap.to(torch.int64)],
                         torch.zeros((), dtype=payload.dtype,
                                     device=payload.device))
    return (blocks.reshape(nm, nk, bs, bc).permute(0, 2, 1, 3)
            .reshape(nm * bs, nk * bc))


def unpack_cuda(payload: torch.Tensor, bitmap: torch.Tensor, slot: torch.Tensor,
                bs: int, bc: int) -> torch.Tensor:
    lib = cuda_library(payload, "zebra_unpack")
    nm, nk = bitmap.shape
    if payload.element_size() not in (2, 4) or not payload.is_contiguous():
        raise ValueError("zebra_unpack: CUDA kernel takes a contiguous payload "
                         "of 2- or 4-byte elements")
    if bitmap.dtype != torch.int8 or slot.dtype != torch.int32:
        raise ValueError("zebra_unpack: expected an int8 bitmap and an int32 "
                         "slot map")
    bitmap, slot = bitmap.contiguous(), slot.contiguous()
    out = torch.empty((nm * bs, nk * bc), dtype=payload.dtype,
                      device=payload.device)
    rc = lib.zebra_unpack_launch(payload.data_ptr(), bitmap.data_ptr(),
                                 slot.data_ptr(), out.data_ptr(), nm * bs,
                                 nk * bc, bs, bc, payload.element_size(),
                                 stream_of(payload))
    check_launch(rc, "zebra_unpack")
    zebra_unpack.launches += 1
    return out


def zebra_unpack(payload: torch.Tensor, bitmap: torch.Tensor, *, bs: int = 8,
                 bc: int = 128) -> torch.Tensor:
    """Inverse of the producer: (n_blocks, bs, bc) payload -> dense (M, K)."""
    keep, slot = slot_map(bitmap)
    return unpack_with_slots(payload, bitmap, keep, slot, bs=bs, bc=bc)


def unpack_with_slots(payload: torch.Tensor, bitmap: torch.Tensor,
                      keep: torch.Tensor, slot: torch.Tensor, *, bs: int,
                      bc: int) -> torch.Tensor:
    """``zebra_unpack`` given the bitmap's ``slot_map`` (as the producer
    computed it)."""
    nm, nk = bitmap.shape
    if tuple(payload.shape) != (nm * nk, bs, bc):
        raise ValueError(f"payload {tuple(payload.shape)} does not match "
                         f"bitmap {(nm, nk)} with block ({bs},{bc})")
    if payload.device.type == "cpu":
        return expand_payload(payload, keep, slot, nm, nk, bs, bc)
    return unpack_cuda(payload, bitmap, slot, bs, bc)


zebra_unpack.launches = 0
