"""The payload GEMM of the ``fused`` backend (``repro.kernels.spmm_cs``).

``zebra_spmm_cs`` computes ``y = mask(x) @ w`` (float32) from the
compressed ``(payload, bitmap)`` stream that ``zebra_mask_pack``
produced, without expanding it: each live block is read from its
consumer-order payload slot, a dead block is skipped (its slot aliases a
live one and is never read). For a CUDA tensor it launches
``zebra_spmm_cs_kernel`` (``csrc/zebra_gemm.cu``), the same device body as
``zebra_spmm.zebra_spmm`` with the payload accessor, so the two are equal
bit for bit on the card, and counts its launches in
``zebra_spmm_cs.launches``. For a CPU tensor it runs the plain version,
``spmm_cs_plain``: the expanded payload (``pack.expand_payload``) as
float32 times ``w`` as float32, which equals the plain ``zebra_spmm`` of
the dense map bit for bit (the same float32 operand, one matmul).
"""
from __future__ import annotations

import torch

from .build import check_launch, cuda_library, stream_of
from .pack import expand_payload
from .schedule import slot_map
from .zebra_spmm import (GEMM_DTYPES, MAX_BS, aligned16, check_cuda_gemm, check_gemm,
                         split_rows, sub_rows)


def spmm_cs_plain(payload: torch.Tensor, w: torch.Tensor, bitmap: torch.Tensor,
                  keep: torch.Tensor, slot: torch.Tensor, bs: int, bc: int
                  ) -> torch.Tensor:
    """Plain version of ``zebra_spmm_cs_kernel``."""
    nm, nk = bitmap.shape
    return expand_payload(payload, keep, slot, nm, nk, bs, bc).float() @ w.float()


def spmm_cs_cuda(payload: torch.Tensor, w: torch.Tensor, bitmap: torch.Tensor,
                 slot: torch.Tensor, bs: int, bc: int) -> torch.Tensor:
    lib = cuda_library(payload, "zebra_spmm_cs")
    check_cuda_gemm(w, bitmap, bs, bc, "zebra_spmm_cs")
    if slot.dtype != torch.int32 or slot.numel() != bitmap.numel():
        raise ValueError("zebra_spmm_cs: expected an int32 slot map of nm*nk entries")
    if tuple(payload.shape) != (bitmap.numel(), bs, bc):
        raise ValueError(f"zebra_spmm_cs: payload {tuple(payload.shape)} does not match "
                         f"bitmap {tuple(bitmap.shape)} with block bs={bs}, bc={bc}")
    if bs > MAX_BS:             # (sub_rows(bs), bc) sub-blocks of the same memory
        bitmap, slot = split_rows(bitmap, slot.reshape(-1), bs)
        payload, bs = payload.reshape(-1, sub_rows(bs), bc), sub_rows(bs)
    nm, nk = bitmap.shape
    N = w.shape[1]
    payload, w = aligned16(payload), aligned16(w)
    bitmap, slot = bitmap.contiguous(), slot.contiguous()
    y = torch.empty((nm * bs, N), dtype=torch.float32, device=payload.device)
    rc = lib.zebra_spmm_cs_launch(payload.data_ptr(), slot.data_ptr(), w.data_ptr(),
                                  bitmap.data_ptr(), y.data_ptr(), nm, nk, N, bs, bc,
                                  GEMM_DTYPES[payload.dtype], stream_of(payload))
    check_launch(rc, "zebra_spmm_cs")
    zebra_spmm_cs.launches += 1
    return y


def zebra_spmm_cs(payload: torch.Tensor, w: torch.Tensor, bitmap: torch.Tensor, *,
                  bs: int = 8, bc: int = 128) -> torch.Tensor:
    """(n_blocks, bs, bc) consumer-order payload x (K, N) weight with the
    (M//bs, K//bc) keep bitmap -> (M, N) float32."""
    keep, slot = slot_map(bitmap)
    return spmm_cs_with_slots(payload, w, bitmap, keep, slot, bs=bs, bc=bc)


def spmm_cs_with_slots(payload: torch.Tensor, w: torch.Tensor, bitmap: torch.Tensor,
                       keep: torch.Tensor, slot: torch.Tensor, *, bs: int, bc: int
                       ) -> torch.Tensor:
    """``zebra_spmm_cs`` given the bitmap's ``slot_map`` (as the producer
    computed it)."""
    nm, nk, _ = check_gemm(bitmap, w, bs, bc, payload.dtype)
    if tuple(payload.shape) != (nm * nk, bs, bc):
        raise ValueError(f"payload {tuple(payload.shape)} != ({nm * nk}, {bs}, {bc})")
    if payload.device.type == "cpu":
        return spmm_cs_plain(payload, w, bitmap, keep, slot, bs, bc)
    return spmm_cs_cuda(payload, w, bitmap, slot, bs, bc)


zebra_spmm_cs.launches = 0
