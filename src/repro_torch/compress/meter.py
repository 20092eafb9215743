"""Measured-bytes accounting (``repro.compress.meter``): reconcile observed
compressed stream lengths against the paper's analytic prediction
(Eq. 2/3).

Per site the meter records what a transport moved, payload bytes
(``n_live * bs * bc * itemsize``) plus packed-index bytes (``ceil(n_blocks
/ 8)``), and compares it with ``stored_bits(spec, zero_frac) / 8``. The two
differ only by index padding: Eq. 3 counts ``n_blocks`` bits, a real
stream rounds the index up to whole bytes, so ``0 <= measured - predicted
< 1`` byte per map (plus float roundoff in the analytic term).
``reconcile`` asserts that bound. Interconnect link records wait for the
distributed item (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

from ..core.bandwidth import reduced_bandwidth_pct, stored_bits
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


class BandwidthMeter:
    """Counts the bytes a transport actually moved, site by site."""

    def __init__(self):
        self.records: list[SiteRecord] = []

    def record(self, site: str, cm: CompressedMap) -> SiteRecord:
        r = SiteRecord(site=site, dense_bytes=cm.dense_bytes(),
                       payload_bytes=cm.payload_bytes(), index_bytes=cm.index_bytes(),
                       n_blocks=cm.n_blocks, n_live=int(cm.n_live), spec=cm.spec())
        self.records.append(r)
        return r

    def record_dense(self, site: str, nbytes: int) -> SiteRecord:
        """An uncompressed transport (incompatible leaf), moved as it is."""
        r = SiteRecord(site=site, dense_bytes=int(nbytes), payload_bytes=int(nbytes),
                       index_bytes=0, n_blocks=0, n_live=0)
        self.records.append(r)
        return r

    # ------------------------------------------------------------------
    def dense_bytes(self) -> int:
        return sum(r.dense_bytes for r in self.records)

    def measured_bytes(self) -> int:
        return sum(r.measured_bytes for r in self.records)

    def measured_reduction_pct(self) -> float:
        base = self.dense_bytes()
        return 100.0 * (1.0 - self.measured_bytes() / base) if base else 0.0

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
        return "\n".join(lines)
