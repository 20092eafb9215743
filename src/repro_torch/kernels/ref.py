"""Plain PyTorch oracles for the Zebra kernels (the correctness contract).

The port of ``repro.kernels.ref``. Layout convention: activations are 2-D
``(M, K)`` maps (batch·seq, or B·C·H for NCHW maps, flattened onto M).
Zebra blocks are ``(bs, bc)`` tiles; bitmap[i, j] == keep for block (i, j).
These oracles are deliberately independent of the kernels and of their
plain versions (``kernels.mask_pack``, ``kernels.pack``).
"""
from __future__ import annotations

import torch


def threshold_as(t_obj: float, dtype: torch.dtype) -> float:
    """``T_obj`` rounded to the map's dtype (through float32), as a Python
    float: the comparator compares ``max|x| >= T_obj`` in the map's dtype."""
    return torch.tensor(t_obj, dtype=torch.float32).to(dtype).item()


def zebra_mask_ref(x: torch.Tensor, t_obj: float, bs: int, bc: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inference-mode Zebra: zero every (bs, bc) block whose max|x| < t_obj
    (a block holding NaN has a NaN max and is dead).

    Returns (masked x, keep bitmap (M//bs, K//bc) int8)."""
    M, K = x.shape
    xb = x.reshape(M // bs, bs, K // bc, bc)
    blockmax = xb.abs().amax(dim=(1, 3))
    keep = blockmax >= threshold_as(t_obj, x.dtype)
    y = (xb * keep[:, None, :, None].to(x.dtype)).reshape(M, K)
    return y, keep.to(torch.int8)


def _to_blocks(x: torch.Tensor, bs: int, bc: int) -> torch.Tensor:
    """(M, K) -> (n_blocks, bs, bc) in row-major block order."""
    M, K = x.shape
    nm, nk = M // bs, K // bc
    return x.reshape(nm, bs, nk, bc).permute(0, 2, 1, 3).reshape(nm * nk, bs, bc)


def _from_blocks(blocks: torch.Tensor, nm: int, nk: int) -> torch.Tensor:
    bs, bc = blocks.shape[-2:]
    return (blocks.reshape(nm, nk, bs, bc).permute(0, 2, 1, 3)
            .reshape(nm * bs, nk * bc))


def zebra_pack_ref(x: torch.Tensor, bitmap: torch.Tensor, bs: int, bc: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compaction oracle: live (bs, bc) blocks first in CONSUMER order —
    grouped by K-block column, columns ascending, block rows ascending
    within a column — then a zeroed tail. Returns (payload (n_blocks, bs,
    bc), n_live () int32). A stable argsort on the (column, row) key, not
    the kernels' prefix-sum scatter."""
    nm, nk = bitmap.shape
    blocks = _to_blocks(x, bs, bc)
    keep = bitmap.reshape(-1).to(torch.int64)
    n_live = keep.sum()
    nb = nm * nk
    g = torch.arange(nb, device=x.device)
    r, k = g // nk, g % nk
    sortkey = torch.where(keep != 0, k * nm + r, nb * nm + g)
    order = torch.argsort(sortkey, stable=True)
    payload = blocks[order]
    live_slot = torch.arange(nb, device=x.device)[:, None, None] < n_live
    payload = torch.where(live_slot, payload, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
    return payload, n_live.to(torch.int32)


def zebra_unpack_ref(payload: torch.Tensor, bitmap: torch.Tensor, bs: int,
                     bc: int) -> torch.Tensor:
    """Inverse of zebra_pack_ref: scatter consumer-order payload slots back
    to (M, K). Dead blocks are where-gated (not multiplied) to exact +0 —
    a dead block's slot aliases a live block, and * would leak NaN/Inf."""
    nm, nk = bitmap.shape
    keep2 = bitmap.to(torch.int64)
    counts = keep2.sum(dim=0)
    offsets = torch.cumsum(counts, 0) - counts
    colrank = torch.cumsum(keep2, 0) - keep2
    src = (offsets[None, :] + colrank).reshape(-1)
    keep = keep2.reshape(-1)
    blocks = torch.where((keep != 0)[:, None, None], payload[src],
                         torch.zeros((), dtype=payload.dtype,
                                     device=payload.device))
    return _from_blocks(blocks, nm, nk)


def zebra_mask_pack_ref(x: torch.Tensor, t_obj: float, bs: int, bc: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Streaming oracle: comparator + compaction composed.

    Returns (payload, bitmap, n_live) — the contract for zebra_mask_pack."""
    y, bitmap = zebra_mask_ref(x, t_obj, bs, bc)
    payload, n_live = zebra_pack_ref(y, bitmap, bs, bc)
    return payload, bitmap, n_live
