"""Compressed activation stream (``repro.compress.stream``): the transport
form of a Zebra-masked map, the bytes the paper's accelerator moves
(Eq. 2/3): a payload of the surviving ``(bs, bc)`` blocks in consumer
order plus a packed 1-bit-per-block keep index.

``compress`` packs through ``kernels.pack.zebra_pack`` and ``decompress``
expands through ``kernels.pack.zebra_unpack``, so on the card both run
the CUDA kernels. Measured byte counts (``payload_bytes`` /
``index_bytes``) are observed stream lengths, which
``meter.BandwidthMeter`` reconciles against ``core.bandwidth.stored_bits``.
``compress(..., checksum=True)`` seals a map with its in-band integrity
word (``integrity.stream_checksum``), which an ingest boundary recomputes
and compares (``integrity.validate_map``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..core.bandwidth import TokenMapSpec
from ..kernels.pack import zebra_pack, zebra_unpack
from ..utils import cdiv, map_tree


# ---------------------------------------------------------------------------
# 1-bit block index (Eq. 3): little-endian bit order, row-major block order
# ---------------------------------------------------------------------------

def pack_bitmap(bitmap: torch.Tensor) -> torch.Tensor:
    """(Mb, Kb) keep flags -> (ceil(n_blocks/8),) uint8. Bit b of byte i is
    block i*8 + b (little-endian within the byte)."""
    flat = (bitmap.reshape(-1) != 0).to(torch.uint8)
    n = flat.numel()
    flat = torch.nn.functional.pad(flat, (0, cdiv(n, 8) * 8 - n))
    weights = torch.tensor([1 << b for b in range(8)], dtype=torch.uint8,
                           device=flat.device)
    return (flat.reshape(-1, 8) * weights).sum(dim=1).to(torch.uint8)


def unpack_bitmap(packed: torch.Tensor, nm: int, nk: int) -> torch.Tensor:
    """Inverse of pack_bitmap -> (nm, nk) int8 keep flags."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, None] >> shifts) & 1
    return bits.reshape(-1)[: nm * nk].reshape(nm, nk).to(torch.int8)


# ---------------------------------------------------------------------------
# The stream object
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompressedMap:
    """One compressed activation map: worst-case payload buffer (live blocks
    first, zero tail), packed index, and the measured live count.

    ``checksum`` is the optional in-band integrity word
    (``integrity.stream_checksum``: a () int64 tensor holding the uint32
    fold), or None for the unchecksummed wire format."""
    payload: torch.Tensor       # (n_blocks, bs, bc), activation dtype
    index: torch.Tensor         # (ceil(n_blocks/8),) uint8
    n_live: torch.Tensor        # () int32
    shape: tuple[int, ...]      # original (pre-flatten) map shape
    m: int                      # flattened rows
    k: int                      # flattened cols
    bs: int
    bc: int
    checksum: torch.Tensor | None = None   # () int64 in [0, 2**32), or None
    # ((dim, start, length), ...): the part of the expanded map its holder
    # keeps (a tensor-parallel rank's part of a gathered cache leaf), or None
    part: tuple[tuple[int, int, int], ...] | None = None

    # --- measured stream accounting (host side: reads n_live back) ---
    @property
    def n_blocks(self) -> int:
        return (self.m // self.bs) * (self.k // self.bc)

    @property
    def itemsize(self) -> int:
        return self.payload.element_size()

    def payload_bytes(self) -> int:
        """Bytes of surviving-block data actually in the stream."""
        return int(self.n_live) * self.bs * self.bc * self.itemsize

    def index_bytes(self) -> int:
        return int(self.index.numel())       # uint8

    def measured_bytes(self) -> int:
        return self.payload_bytes() + self.index_bytes()

    def dense_bytes(self) -> int:
        return self.m * self.k * self.itemsize

    def zero_frac(self) -> float:
        return 1.0 - int(self.n_live) / max(self.n_blocks, 1)

    def spec(self) -> TokenMapSpec:
        """The analytic map spec this stream instantiates (for Eq. 2/3)."""
        return TokenMapSpec(s=self.m, d=self.k, bits=self.itemsize * 8,
                            block_seq=self.bs, block_ch=self.bc)


# ---------------------------------------------------------------------------
# Codec entry points
# ---------------------------------------------------------------------------

def nonzero_bitmap(x: torch.Tensor, bs: int, bc: int) -> torch.Tensor:
    """Keep flags for lossless transport of an already-masked map: keep any
    block with at least one nonzero element."""
    M, K = x.shape
    xb = x.reshape(M // bs, bs, K // bc, bc)
    return (xb.abs().amax(dim=(1, 3)) > 0).to(torch.int8)


def compress(x: torch.Tensor, bitmap: torch.Tensor | None = None, *, bs: int = 8,
             bc: int = 128, checksum: bool = False) -> CompressedMap:
    """(..., K) map -> CompressedMap. Leading dims flatten onto M. With no
    bitmap the nonzero-block bitmap is used (always lossless).
    ``checksum=True`` seals the map with its integrity word."""
    shape = tuple(x.shape)
    x2 = x.reshape(-1, shape[-1])
    M, K = x2.shape
    if bitmap is None:
        bitmap = nonzero_bitmap(x2, bs, bc)
    payload, n_live = zebra_pack(x2, bitmap, bs=bs, bc=bc)
    cm = CompressedMap(payload=payload, index=pack_bitmap(bitmap), n_live=n_live,
                       shape=shape, m=M, k=K, bs=bs, bc=bc)
    if checksum:
        from .integrity import attach_checksum
        cm = attach_checksum(cm)
    return cm


def decompress(cm: CompressedMap) -> torch.Tensor:
    bitmap = unpack_bitmap(cm.index, cm.m // cm.bs, cm.k // cm.bc)
    x = zebra_unpack(cm.payload, bitmap, bs=cm.bs, bc=cm.bc).reshape(cm.shape)
    if cm.part is None:
        return x
    for dim, start, n in cm.part:
        x = x.narrow(dim, start, n)
    return x.contiguous()


# ---------------------------------------------------------------------------
# Tree transport (the prefill -> decode KV-cache handoff)
# ---------------------------------------------------------------------------

def leaf_dims(shape: tuple[int, ...], bs: int, bc: int) -> tuple[int, int] | None:
    """The (m, k) flattening a leaf of ``shape`` compresses under: the last
    axis, else the last two, whichever first divides into (bs, bc) blocks."""
    for nd in (1, 2):
        k = math.prod(shape[-nd:])
        m = math.prod(shape[:-nd]) if len(shape) > nd else 0
        if m and k % bc == 0 and m % bs == 0:
            return m, k
    return None


def on_block_edges(local: tuple, dim: int, nd: int, bs: int, bc: int) -> bool:
    """Whether a rank's equal part of a map along ``dim`` (negative; its
    part's extent ``local[dim]``) is whole (bs, bc) blocks of the map's
    (rows, last ``nd`` dims) flattening: a column dimension must be the
    first of the columns, its part's columns a multiple of bc; a row
    dimension's part is a run of rows, with those of the dimensions inside
    it, a multiple of bs."""
    if dim >= -nd:
        return dim == -nd and math.prod(local[-nd:]) % bc == 0
    return math.prod(local[dim:-nd]) % bs == 0


def pack_plan(local: tuple, cuts, nd: int, bs: int, bc: int):
    """How a rank packs its part of a map whose whole (rows, last ``nd``
    dims) flattening compresses in (bs, bc) blocks, for ``cuts``, a
    sequence of (axis, dim, cut): the map is this rank's part along
    ``dim`` over ``axis`` (a ``CommAxis``: ``size``, ``index``) where
    ``cut`` is true, else whole over it. A part on block edges
    (:func:`on_block_edges`) is packed as it is; any other part is
    gathered over its axis and packed whole. Returns ((axis, dim) to
    gather over, in order) and whether this rank counts the packed map's
    live blocks: a map whole over an axis is counted on that axis's first
    rank alone. The rule of the tensor-parallel handoff
    (``launch.serve.compress_tree_tp``) and of the paged pool's pages."""
    shape, gathers, owned = list(local), [], True
    for axis, dim, cut in cuts:
        if cut and on_block_edges(tuple(shape), dim, nd, bs, bc):
            continue
        owned = owned and axis.index == 0
        if cut:
            gathers.append((axis, dim))
            shape[dim] *= axis.size
    return gathers, owned


def _leaf_dims(leaf, bs: int, bc: int) -> tuple[int, int] | None:
    if not (isinstance(leaf, torch.Tensor) and leaf.dim() >= 2
            and leaf.is_floating_point()):
        return None
    return leaf_dims(tuple(leaf.shape), bs, bc)


def compress_tree(tree: Any, *, bs: int = 8, bc: int = 128, meter=None,
                  site: str = "acts", checksum: bool = False) -> Any:
    """Compress every compatible floating leaf of a tree (lossless,
    nonzero-block bitmap); incompatible leaves pass through dense. Each leaf
    is recorded on ``meter`` under ``"<site>/<path>"``, so the index bytes
    are counted per leaf, as the reference counts them. ``checksum=True``
    seals every compressed leaf."""

    def one(path, leaf):
        name = "/".join([site, *map(str, path)])
        dims = _leaf_dims(leaf, bs, bc)
        if dims is None:
            if meter is not None:
                meter.record_dense(name, leaf.numel() * leaf.element_size())
            return leaf
        cm = dataclasses.replace(compress(leaf.reshape(dims), bs=bs, bc=bc,
                                          checksum=checksum),
                                 shape=tuple(leaf.shape))
        if meter is not None:
            meter.record(name, cm)
        return cm

    return map_tree(one, tree)


def decompress_tree(tree: Any) -> Any:
    return map_tree(lambda _, l: decompress(l) if isinstance(l, CompressedMap) else l,
                     tree)
