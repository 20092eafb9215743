"""Memory-bandwidth accounting — paper Eq. (2)-(5) and Table V.

A copy of ``repro.core.bandwidth`` (plain Python; the port keeps its own).
All sizes in *bits* unless a function says bytes. The paper assumes
layer-by-layer accelerator processing: every conv layer's activation map is
written to external DRAM and read back by the next layer, so total
"required bandwidth" = Σ_layers map_size (Table V reports this per image).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class MapSpec:
    """One activation map written to DRAM/HBM."""
    c: int
    h: int
    w: int
    bits: int = 16        # B in Eq. 2
    block: int = 4        # block_size (per side)

    @property
    def elems(self) -> int:
        return self.c * self.h * self.w

    @property
    def map_bits(self) -> int:
        return self.elems * self.bits

    @property
    def n_blocks(self) -> int:
        return self.c * (self.h // self.block) * (self.w // self.block)

    @property
    def index_bits(self) -> int:
        """Eq. 3: one bit per block => C*W*H / block_size^2 bits."""
        return self.n_blocks


@dataclasses.dataclass(frozen=True)
class TokenMapSpec:
    """LM-layout map (S, D) with (bs x bc) tile blocks."""
    s: int
    d: int
    bits: int = 16
    block_seq: int = 8
    block_ch: int = 128

    @property
    def elems(self) -> int:
        return self.s * self.d

    @property
    def map_bits(self) -> int:
        return self.elems * self.bits

    @property
    def n_blocks(self) -> int:
        return (self.s // self.block_seq) * (self.d // self.block_ch)

    @property
    def index_bits(self) -> int:
        return self.n_blocks


def stored_bits(spec, zero_frac: float) -> float:
    """Eq. 2 (+3): surviving data bits + index bits actually written."""
    return spec.map_bits * (1.0 - zero_frac) + spec.index_bits


def reduced_bandwidth_pct(specs: Sequence, zero_fracs: Sequence[float]) -> float:
    """Paper's 'Reduced bandwidth (%)' — net saving incl. index overhead."""
    base = sum(s.map_bits for s in specs)
    with_zebra = sum(stored_bits(s, z) for s, z in zip(specs, zero_fracs))
    return 100.0 * (1.0 - with_zebra / base)


def index_overhead_pct(specs: Sequence) -> float:
    """Table V: bandwidth overhead of block indices vs required bandwidth."""
    base = sum(s.map_bits for s in specs)
    idx = sum(s.index_bits for s in specs)
    return 100.0 * idx / base


def required_bandwidth_bytes(specs: Sequence) -> float:
    return sum(s.map_bits for s in specs) / 8.0
