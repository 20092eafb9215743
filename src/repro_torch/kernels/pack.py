"""The compressed-stream expander (``repro.kernels.pack``).

``zebra_unpack`` is the inverse of the producer: the consumer-order
payload ``(n_blocks, bs, bc)`` and the keep bitmap back to the dense
``(M, K)`` map, dead blocks as exact +0. For a CUDA tensor it launches
``zebra_unpack_kernel`` (``csrc/zebra_stream.cu``) and counts the launch
in ``zebra_unpack.launches``; for a CPU tensor it runs the plain version,
``expand_payload``.

``zebra_pack`` (compacting an already-masked map under a given bitmap)
is not ported yet: see ROADMAP.md, kernel queue.
"""
from __future__ import annotations

import torch

from .build import check_launch, cuda_library, stream_of
from .schedule import slot_map


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
