"""The one-pass Zebra masking kernel of the ``pallas`` backend
(``repro.kernels.zebra_mask``, paper Fig. 3 in inference mode).

``zebra_mask`` reads an ``(M, K)`` activation map once and writes the
masked map and its int8 keep bitmap: every ``(bs, bc)`` block whose
``max|x|`` is below ``T_obj`` (or holds NaN) is multiplied by 0, every
other block by 1. The product, not a select: a dead block of negative
values comes out as ``-0.0`` and one holding NaN as NaN, as the Pallas
kernel and ``kernels.ref.zebra_mask_ref`` give.

For a CUDA tensor the wrapper launches ``zebra_mask_kernel``
(``csrc/zebra_stream.cu``) or raises, and counts the launch in
``zebra_mask.launches``; for a CPU tensor it runs the plain version,
``mask_plain``.
"""
from __future__ import annotations

import torch

from .build import check_launch, cuda_library, stream_of
from .mask_pack import _DTYPE_CODES, _check_cuda_map, _check_map, bitmap_plain
from .ref import threshold_as


def mask_plain(x: torch.Tensor, t_obj: float, bs: int, bc: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``zebra_mask_kernel``: (masked x, int8 bitmap)."""
    nm, nk = _check_map(x, bs, bc)
    bitmap = bitmap_plain(x, t_obj, bs, bc)
    y = x.reshape(nm, bs, nk, bc) * bitmap[:, None, :, None].to(x.dtype)
    return y.reshape(x.shape), bitmap


def mask_cuda(x: torch.Tensor, t_obj: float, bs: int, bc: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    lib = cuda_library(x, "zebra_mask")
    nm, nk = _check_map(x, bs, bc)
    _check_cuda_map(x, "zebra_mask")
    y = torch.empty_like(x)
    bitmap = torch.empty((nm, nk), dtype=torch.int8, device=x.device)
    rc = lib.zebra_mask_launch(x.data_ptr(), y.data_ptr(), bitmap.data_ptr(),
                               x.shape[0], x.shape[1], bs, bc,
                               threshold_as(t_obj, x.dtype), _DTYPE_CODES[x.dtype],
                               stream_of(x))
    check_launch(rc, "zebra_mask")
    zebra_mask.launches += 1
    return y, bitmap


def zebra_mask(x: torch.Tensor, *, t_obj: float, bs: int = 8, bc: int = 128
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, K) -> (masked (M, K), keep bitmap (M//bs, K//bc) int8)."""
    if x.device.type == "cpu":
        return mask_plain(x, t_obj, bs, bc)
    return mask_cuda(x, t_obj, bs, bc)


zebra_mask.launches = 0
