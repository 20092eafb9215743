"""Block-sparse activation x dense weight GEMM from a dense operand
(``repro.kernels.zebra_spmm``)::

    y[M, N] (float32) = (x ⊙ blockmask)[M, K] @ w[K, N]

``zebra_spmm`` takes the dense ``(M, K)`` map and its ``(M//bs, K//bc)``
keep bitmap; a dead block is skipped, not multiplied. For a CUDA tensor it
launches ``zebra_spmm_kernel`` (``csrc/zebra_gemm.cu``), which is the same
device body as the payload consumer ``spmm_cs.zebra_spmm_cs`` with only
the block accessor changed, so on the card the two are equal bit for bit;
it counts its launches in ``zebra_spmm.launches``. The dtype picks the
body: bfloat16 and float16 run on the tensor cores (``mma.sync``),
float32 on the CUDA cores (``fmaf``), the same for both kernels. For a
CPU tensor it runs the plain version, ``spmm_plain``: the keep-gated map
(a select, so dead blocks are exact +0 whatever x holds) as float32 times
``w`` as float32.

The kernel holds 8 block rows in registers. A block of more rows runs as
j sub-blocks of ``r = sub_rows(bs)`` rows (the largest divisor of bs that
is at most 8: bs 12 as two 6-row halves, bs 24 as three 8-row thirds)
that share its keep bit (``split_rows``): the bitmap row-repeats j times
and the payload is viewed as ``(j·nb, r, bc)``, so neither the memory nor
the ascending-K order changes.

The TPU realizations' tile machinery (``gemm_plan`` supertiles, the
scheduled capacity ladder) has no counterpart: a tile choice never
changes an observable, and the kernel sums every output in ascending K.
"""
from __future__ import annotations

import torch

from .build import check_launch, cuda_library, stream_of
# the operand dtypes of the GEMM bodies (csrc/zebra_gemm.cu's dtype codes):
# float32 runs the CUDA-core body, bfloat16 and float16 the tensor-core body
GEMM_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_BS = 8          # block rows the CUDA kernel holds in registers
# the tensor-core body (bfloat16, float16): the CTA's keep map, 4 bytes per
# K-block column, sits beside the 96 KiB ring in the 227 KiB of shared
# memory a CTA may have (csrc/zebra_gemm.cu, tc_smem_bytes)
MAX_BF16_NK = (232448 - 98304) // 4


def check_gemm(bitmap: torch.Tensor, w: torch.Tensor, bs: int, bc: int,
               dtype: torch.dtype) -> tuple[int, int, int]:
    """(nm, nk, N) of a block GEMM; raises on shapes that do not fit."""
    if bitmap.dim() != 2 or w.dim() != 2:
        raise ValueError("expected a 2-D bitmap and a 2-D (K, N) weight")
    nm, nk = bitmap.shape
    K, N = w.shape
    if K != nk * bc:
        raise ValueError(f"w rows {K} != bitmap cols {nk} * bc {bc}")
    if w.dtype != dtype:
        raise TypeError(f"w is {w.dtype}, the activations {dtype}")
    return nm, nk, N


def check_cuda_gemm(w: torch.Tensor, bitmap: torch.Tensor, bs: int, bc: int,
                    kernel: str) -> None:
    """Raises on what the CUDA GEMM kernels do not take."""
    if w.dtype not in GEMM_DTYPES:
        raise TypeError(f"{kernel}: CUDA kernel takes float32, bfloat16 or float16, "
                        f"got {w.dtype}")
    if bs < 1:
        raise ValueError(f"{kernel}: CUDA kernel takes bs >= 1, got bs={bs}")
    if bitmap.dtype != torch.int8:
        raise ValueError(f"{kernel}: expected an int8 bitmap")
    if w.dtype != torch.float32:
        if bc % 8:
            raise ValueError(f"{kernel}: the {w.dtype} kernel stages 16-byte block rows, "
                             f"so bc must be a multiple of 8, got {bc}")
        if bitmap.shape[1] > MAX_BF16_NK:
            raise ValueError(f"{kernel}: the {w.dtype} kernel keeps at most {MAX_BF16_NK} "
                             f"K-block columns in shared memory, got {bitmap.shape[1]}")


def sub_rows(bs: int) -> int:
    """Rows of the sub-blocks a ``bs``-row block runs as: the largest
    divisor of bs that is at most ``MAX_BS``."""
    return max(r for r in range(1, min(bs, MAX_BS) + 1) if bs % r == 0)


def split_rows(bitmap: torch.Tensor, slot: torch.Tensor | None, bs: int
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The ``(bitmap, slot)`` of a GEMM with ``bs = j·r`` row blocks (``r =
    sub_rows(bs)``), cut into (r, bc) sub-blocks: sub-block row ``j·i + h``
    keeps block row i's bits, and its slot is ``j·slot + h`` into the
    payload viewed as ``(j·nb, r, bc)`` (a dead block's slot aliases a live
    one and is never read). ``slot`` is the flat (nm·nk) map of
    ``slot_map``, or None (the dense form needs no slots)."""
    j = bs // sub_rows(bs)
    nm, nk = bitmap.shape
    bitmap8 = bitmap.repeat_interleave(j, dim=0)
    if slot is None:
        return bitmap8, None
    h = torch.arange(j, dtype=slot.dtype, device=slot.device)
    slot8 = slot.reshape(nm, 1, nk) * j + h[None, :, None]
    return bitmap8, slot8.reshape(-1)


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """A contiguous ``t`` whose data starts on 16 bytes (cp.async's copy
    size): ``t`` itself, or a fresh copy if its storage offset breaks that."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def gate_blocks(x: torch.Tensor, bitmap: torch.Tensor, bs: int, bc: int) -> torch.Tensor:
    """x with every dead (bs, bc) block replaced by exact +0 (a select)."""
    nm, nk = bitmap.shape
    keep = (bitmap != 0)[:, None, :, None]
    xb = x.reshape(nm, bs, nk, bc)
    return torch.where(keep, xb, torch.zeros((), dtype=x.dtype, device=x.device)
                       ).reshape(x.shape)


def spmm_plain(x: torch.Tensor, w: torch.Tensor, bitmap: torch.Tensor, bs: int,
               bc: int) -> torch.Tensor:
    """Plain version of ``zebra_spmm_kernel``: keep-gated x @ w in float32."""
    return gate_blocks(x, bitmap, bs, bc).float() @ w.float()


def spmm_cuda(x: torch.Tensor, w: torch.Tensor, bitmap: torch.Tensor, bs: int,
              bc: int) -> torch.Tensor:
    lib = cuda_library(x, "zebra_spmm")
    check_cuda_gemm(w, bitmap, bs, bc, "zebra_spmm")
    M, K = x.shape
    N = w.shape[1]
    if (M, K) != (bitmap.shape[0] * bs, bitmap.shape[1] * bc):
        raise ValueError(f"zebra_spmm: x {(M, K)} does not match bitmap "
                         f"{tuple(bitmap.shape)} with block bs={bs}, bc={bc}")
    if bs > MAX_BS:
        bitmap, _ = split_rows(bitmap, None, bs)
        bs = sub_rows(bs)
    x, w, bitmap = aligned16(x), aligned16(w), bitmap.contiguous()
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    rc = lib.zebra_spmm_launch(x.data_ptr(), w.data_ptr(), bitmap.data_ptr(),
                               y.data_ptr(), M, K, N, bs, bc, GEMM_DTYPES[x.dtype],
                               stream_of(x))
    check_launch(rc, "zebra_spmm")
    zebra_spmm.launches += 1
    return y


def zebra_spmm(x: torch.Tensor, w: torch.Tensor, bitmap: torch.Tensor, *,
               bs: int = 8, bc: int = 128) -> torch.Tensor:
    """(M, K) x (K, N) with an (M//bs, K//bc) keep bitmap -> (M, N) float32."""
    nm, nk, _ = check_gemm(bitmap, w, bs, bc, x.dtype)
    if tuple(x.shape) != (nm * bs, nk * bc):
        raise ValueError(f"x {tuple(x.shape)} does not match bitmap {(nm, nk)} "
                         f"with block ({bs},{bc})")
    if x.device.type == "cpu":
        return spmm_plain(x, w, bitmap, bs, bc)
    return spmm_cuda(x, w, bitmap, bs, bc)


zebra_spmm.launches = 0
