"""Measured-bytes accounting (``repro.compress.meter``): reconcile observed
compressed stream lengths against the paper's analytic prediction
(Eq. 2/3).

Per site the meter records what a transport moved, payload bytes
(``n_live * bs * bc * itemsize``) plus packed-index bytes (``ceil(n_blocks
/ 8)``), and compares it with ``stored_bits(spec, zero_frac) / 8``. The two
differ only by index padding: Eq. 3 counts ``n_blocks`` bits, a real
stream rounds the index up to whole bytes, so ``0 <= measured - predicted
< 1`` byte per map (plus float roundoff in the analytic term).
``reconcile`` asserts that bound.

Interconnect links (``distributed.collectives``) get the same treatment
through ``record_link``: one record per (site, mesh axis) covering the
``n_maps`` per-shard maps an inbound link carried, reconciled against
``n_maps * stored_bits(spec, mean zero_frac)``, exact because
``stored_bits`` is linear in ``zero_frac``. The padding bound scales to
``n_maps`` bytes (one index rounding per map).
"""
from __future__ import annotations

import dataclasses

from ..core.bandwidth import TokenMapSpec, reduced_bandwidth_pct, stored_bits
from ..utils import human_bytes
from .stream import CompressedMap


@dataclasses.dataclass
class SiteRecord:
    site: str
    dense_bytes: int
    payload_bytes: int
    index_bytes: int
    n_blocks: int
    n_live: int
    spec: object | None = None       # TokenMapSpec for compressed sites

    @property
    def compressed(self) -> bool:
        return self.spec is not None

    @property
    def measured_bytes(self) -> int:
        return self.payload_bytes + self.index_bytes

    @property
    def zero_frac(self) -> float:
        if not self.n_blocks:
            return 0.0
        return 1.0 - self.n_live / self.n_blocks

    @property
    def predicted_bytes(self) -> float:
        """Eq. 2 (+3) stored size at this site's measured zero fraction."""
        if not self.compressed:
            return float(self.dense_bytes)
        return stored_bits(self.spec, self.zero_frac) / 8.0


@dataclasses.dataclass
class LinkRecord:
    """Bytes one inbound interconnect link carried for one collective:
    ``n_maps`` per-shard compressed streams (all-gather: the other ``n - 1``
    shards' maps; the psum ring: ``n - 1`` union-capacity payloads).
    ``n_blocks`` and ``spec`` describe one shard map; ``n_live`` is the
    total over the maps the link moved."""
    site: str
    axis: str
    dense_bytes: int
    payload_bytes: int
    index_bytes: int
    n_blocks: int                    # blocks per map
    n_live: int                      # live blocks over the n_maps maps
    n_maps: int
    spec: object                     # TokenMapSpec of one shard map

    @property
    def measured_bytes(self) -> int:
        return self.payload_bytes + self.index_bytes

    @property
    def zero_frac(self) -> float:
        total = self.n_blocks * self.n_maps
        return 1.0 - self.n_live / total if total else 0.0

    @property
    def predicted_bytes(self) -> float:
        """Eq. 2/3 over the link's maps: ``stored_bits`` is linear in the
        zero fraction, so the sum over the maps is ``n_maps`` times its
        value at the mean."""
        return self.n_maps * stored_bits(self.spec, self.zero_frac) / 8.0


class BandwidthMeter:
    """Counts the bytes a transport actually moved, site by site, and the
    bytes each interconnect link carried."""

    def __init__(self):
        self.records: list[SiteRecord] = []
        self.links: list[LinkRecord] = []

    def record(self, site: str, cm: CompressedMap) -> SiteRecord:
        r = SiteRecord(site=site, dense_bytes=cm.dense_bytes(),
                       payload_bytes=cm.payload_bytes(), index_bytes=cm.index_bytes(),
                       n_blocks=cm.n_blocks, n_live=int(cm.n_live), spec=cm.spec())
        self.records.append(r)
        return r

    def record_counts(self, site: str, *, m: int, k: int, bs: int, bc: int,
                      itemsize: int, n_live: int) -> SiteRecord:
        """A compressed (m, k) map in (bs, bc) blocks known by its counts
        alone: a map whose shards several ranks hold, counted once with
        its whole block count (one packed index, as one stream)."""
        nb = (m // bs) * (k // bc)
        r = SiteRecord(site=site, dense_bytes=m * k * itemsize,
                       payload_bytes=int(n_live) * bs * bc * itemsize,
                       index_bytes=(nb + 7) // 8, n_blocks=nb, n_live=int(n_live),
                       spec=TokenMapSpec(s=m, d=k, bits=itemsize * 8, block_seq=bs,
                                         block_ch=bc))
        self.records.append(r)
        return r

    def record_dense(self, site: str, nbytes: int) -> SiteRecord:
        """An uncompressed transport (incompatible leaf), moved as it is."""
        r = SiteRecord(site=site, dense_bytes=int(nbytes), payload_bytes=int(nbytes),
                       index_bytes=0, n_blocks=0, n_live=0)
        self.records.append(r)
        return r

    def record_link(self, site: str, axis: str, *, m: int, k: int, bs: int, bc: int,
                    dtype_bits: int, n_live: int, n_maps: int,
                    dense_bytes: int | None = None) -> LinkRecord:
        """One inbound link of a compressed collective: ``n_maps`` per-shard
        (m, k) maps in (bs, bc) blocks, ``n_live`` live blocks in all. The
        byte rule is ``core.engine.stream_bytes`` per map: payload plus one
        byte-rounded packed index each."""
        nb = (m // bs) * (k // bc)
        payload = int(n_live) * bs * bc * dtype_bits // 8
        index = int(n_maps) * ((nb + 7) // 8)
        if dense_bytes is None:
            dense_bytes = int(n_maps) * m * k * dtype_bits // 8
        r = LinkRecord(site=site, axis=axis, dense_bytes=int(dense_bytes),
                       payload_bytes=payload, index_bytes=index, n_blocks=nb,
                       n_live=int(n_live), n_maps=int(n_maps),
                       spec=TokenMapSpec(s=m, d=k, bits=dtype_bits, block_seq=bs,
                                         block_ch=bc))
        self.links.append(r)
        return r

    # ------------------------------------------------------------------
    def dense_bytes(self) -> int:
        return sum(r.dense_bytes for r in self.records)

    def measured_bytes(self) -> int:
        return sum(r.measured_bytes for r in self.records)

    def measured_reduction_pct(self) -> float:
        base = self.dense_bytes()
        return 100.0 * (1.0 - self.measured_bytes() / base) if base else 0.0

    def ici_bytes(self, axis: str | None = None) -> int:
        """Interconnect bytes the links moved (on one mesh axis, or all)."""
        return sum(r.measured_bytes for r in self.links if axis is None or r.axis == axis)

    def ici_dense_bytes(self, axis: str | None = None) -> int:
        return sum(r.dense_bytes for r in self.links if axis is None or r.axis == axis)

    def ici_per_axis(self) -> dict[str, tuple[int, int]]:
        """{axis: (moved, dense-equivalent)} over every recorded link."""
        out: dict[str, tuple[int, int]] = {}
        for r in self.links:
            m, d = out.get(r.axis, (0, 0))
            out[r.axis] = (m + r.measured_bytes, d + r.dense_bytes)
        return out

    def predicted_reduction_pct(self) -> float:
        """Eq. 2/3 prediction over the compressed sites, at the measured
        per-site zero fractions (dense sites count their full size)."""
        comp = [r for r in self.records if r.compressed]
        if not comp:
            return 0.0
        pct = reduced_bandwidth_pct([r.spec for r in comp], [r.zero_frac for r in comp])
        dense = sum(r.dense_bytes for r in self.records if not r.compressed)
        base = self.dense_bytes()
        return pct * (1.0 - dense / base) if base else pct

    # ------------------------------------------------------------------
    def reconcile(self, tol_bytes_per_map: float = 1.0) -> dict:
        """Measured vs predicted site by site. Returns the worst absolute
        delta; raises if any site leaves the index-padding bound (< 1 byte
        per map; ``tol_bytes_per_map`` adds slack for float roundoff)."""
        deltas = {}
        for r in self.records:
            if not r.compressed:
                continue
            delta = r.measured_bytes - r.predicted_bytes
            deltas[r.site] = delta
            if not (-tol_bytes_per_map <= delta < 1.0 + tol_bytes_per_map):
                raise AssertionError(
                    f"site {r.site}: measured {r.measured_bytes} B vs predicted "
                    f"{r.predicted_bytes:.2f} B (delta {delta:.2f} exceeds "
                    f"index-padding bound)")
        for r in self.links:
            # one index rounding per map the link carried
            delta = r.measured_bytes - r.predicted_bytes
            key = f"link:{r.site}@{r.axis}"
            deltas[key] = delta
            if not (-r.n_maps * tol_bytes_per_map <= delta
                    < r.n_maps * (1.0 + tol_bytes_per_map)):
                raise AssertionError(
                    f"{key}: measured {r.measured_bytes} B vs predicted "
                    f"{r.predicted_bytes:.2f} B (delta {delta:.2f} exceeds the "
                    f"{r.n_maps}-map index-padding bound)")
        return {"n_sites": len(deltas),
                "max_abs_delta_bytes": max((abs(d) for d in deltas.values()), default=0.0),
                "deltas": deltas}

    def report(self, max_rows: int = 12) -> str:
        lines = [f"{'site':42s} {'dense':>10s} {'measured':>10s} "
                 f"{'pred':>10s} {'zero%':>6s}"]
        for r in self.records[:max_rows]:
            lines.append(
                f"{r.site[:42]:42s} {human_bytes(r.dense_bytes):>10s} "
                f"{human_bytes(r.measured_bytes):>10s} "
                f"{human_bytes(r.predicted_bytes):>10s} "
                f"{100 * r.zero_frac:5.1f}%")
        if len(self.records) > max_rows:
            lines.append(f"  ... {len(self.records) - max_rows} more sites")
        lines.append(
            f"TOTAL dense {human_bytes(self.dense_bytes())} -> measured "
            f"{human_bytes(self.measured_bytes())}  "
            f"(measured reduction {self.measured_reduction_pct():.2f}%, "
            f"predicted {self.predicted_reduction_pct():.2f}%)")
        for axis, (moved, dense) in self.ici_per_axis().items():
            n = sum(r.axis == axis for r in self.links)
            lines.append(
                f"LINKS {axis}: {n} records, dense {human_bytes(dense)} -> moved "
                f"{human_bytes(moved)} ({100 * (1 - moved / dense) if dense else 0.0:.2f}% "
                f"less)")
        return "\n".join(lines)
