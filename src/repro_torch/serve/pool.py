"""Paged pool of compressed KV payload slabs (``repro.serve.pool``).

The serving engine keeps only the in-flight lanes' caches dense (the
"hot" working set); everything else (freshly prefilled requests on their
way into a lane, requests evicted under slot pressure, crash snapshots)
lives here as Zebra ``(bitmap, payload)`` streams. A page is
``page_tokens`` consecutive cache positions of one leaf, flattened to
``(rows, Hkv*hd)`` as ``attention.zebra_kv_site`` lays the cache out, and
compressed with the stream codec (``compress.compress`` /
``decompress``): on the card each page out is one launch of the codec's
pack (``zebra_pack``) and each page in one launch of the expander
(``zebra_unpack_kernel``); on the CPU they are the plain versions. The
pool is the transport, so every page is metered on its
``BandwidthMeter`` (Eq. 2/3 reconciliation per page) and validated at
ingest with ``compress.integrity``: a corrupt page degrades to a dense
page, never the whole request.

Block sizing follows the ``ffn.eff_block_ch`` fallback: a page whose
``Hkv*hd`` does not divide ``zebra_block_ch`` compresses at ``bc =
Hkv*hd``, so the stream stays a stream at every scale.

Leaves without a page-divisible token axis are stored dense and metered
as dense traffic. Every stored tensor is a copy: the hot set the engine
pages out from is written again by the next decode step.
"""
from __future__ import annotations

import itertools
import math
from typing import Any

import torch

from ..compress import BandwidthMeter, CompressedMap, compress, decompress
from ..compress.integrity import validate_level, validate_map
from ..ft.faults import CorruptStream
from ..ft.inject import STREAM_KINDS, active_plan, corrupt_map
from ..utils import map_tree

PAGE_SITE = "page"          # ft.inject site label for page-ingest chaos


class _Slab:
    """One request's paged store: per-leaf page lists and the tree they
    reassemble into (``template``: the cache tree with each leaf replaced
    by its index in pytree order)."""

    def __init__(self, template):
        self.template = template
        self.leaves: list[tuple[str, Any]] = []   # ("paged", [...]) | ("dense", tensor)
        self.page_shapes: list[tuple[int, ...] | None] = []


class PagedKVPool:
    """Compressed page-in/page-out store keyed by request id.

    ``page_out(rid, caches)`` replaces any previous slab for ``rid``: the
    stream is re-emitted and re-metered (eviction traffic is real
    traffic). ``page_in(rid)`` decompresses the slab back to the dense
    per-request tree, bitwise equal to what was paged out (pages that
    failed ingest validation were kept dense, so bitwise equal too). The
    device of each page decides the codec's route, as ``compress`` does.
    """

    def __init__(self, *, page_tokens: int = 16, bs: int = 8, bc: int = 128,
                 validation: str = "off", breaker=None):
        if page_tokens & (page_tokens - 1) or page_tokens < 1:
            raise ValueError(f"page_tokens must be a power of two, got {page_tokens}")
        self.page_tokens = page_tokens
        self.bs, self.bc = bs, bc
        self.validation = validate_level(validation)
        self.breaker = breaker    # ft.breaker.BreakerBoard | None: the
                                  # page-ingest circuit; open means pages
                                  # skip compress and validation wholesale
        self.meter = BandwidthMeter()
        self._slabs: dict[Any, _Slab] = {}
        self.n_pages_out = 0
        self.n_pages_in = 0
        self.n_recovered = 0      # corrupt pages kept dense at ingest
        self.n_breaker_dense = 0  # pages sent dense by an open breaker
        self.bytes_out = 0        # stream bytes written to the pool
        self.bytes_in = 0         # stream bytes read back out

    # ------------------------------------------------------------------
    def _eff_blocks(self, m: int, k: int) -> tuple[int, int]:
        """eff_block_ch-style divisor fallback, so pages compress even when
        the reduced head dims do not divide the configured blocks."""
        bs = self.bs if m % self.bs == 0 else 1
        bc = self.bc if k % self.bc == 0 else k
        return bs, bc

    def _encode(self, page2d: torch.Tensor) -> CompressedMap:
        bs, bc = self._eff_blocks(*page2d.shape)
        return compress(page2d, bs=bs, bc=bc, checksum=(self.validation == "checksum"))

    @staticmethod
    def _pageable(leaf) -> bool:
        """Attention cache leaves: (..., B, T, Hkv, hd), T at axis -3 (the
        ``model_prefill_pad`` convention)."""
        return (isinstance(leaf, torch.Tensor) and leaf.dim() >= 4
                and leaf.is_floating_point())

    @staticmethod
    def _nbytes(t: torch.Tensor) -> int:
        return t.numel() * t.element_size()

    def _dense_page(self, name: str, page: torch.Tensor) -> torch.Tensor:
        dense = page.clone()
        nbytes = self._nbytes(dense)
        self.meter.record_dense(name, nbytes)
        self.bytes_out += nbytes
        return dense

    # ------------------------------------------------------------------
    def page_out(self, rid, caches) -> None:
        """Compress a per-request cache tree into the slab store. The ingest
        boundary: an armed chaos plan (``ft.inject``) with a stream fault at
        site ``"page"`` corrupts pages here, after compression and before
        validation, and a page that fails ``validate_map`` is kept dense
        (per-page fallback)."""
        leaves = []
        count = itertools.count()

        def index(_, leaf):
            leaves.append(leaf)
            return next(count)
        slab = _Slab(map_tree(index, caches))
        plan = active_plan()
        pt = self.page_tokens
        for i, leaf in enumerate(leaves):
            T = leaf.shape[-3] if self._pageable(leaf) else 0
            if not T or T % pt:
                slab.leaves.append(("dense", leaf.clone()))
                slab.page_shapes.append(None)
                nbytes = self._nbytes(leaf)
                self.meter.record_dense(f"req{rid}/leaf{i}", nbytes)
                self.bytes_out += nbytes
                continue
            k = math.prod(leaf.shape[-2:])
            pages = []
            page_shape = tuple(leaf.shape[:-3]) + (pt,) + tuple(leaf.shape[-2:])
            ax = leaf.dim() - 3
            for p in range(T // pt):
                page = leaf.narrow(ax, p * pt, pt)
                name = f"req{rid}/leaf{i}/pg{p}"
                if self.breaker is not None and not self.breaker.allow(PAGE_SITE):
                    # circuit open: the compressed path at this boundary is
                    # sick, so dense wholesale, skipping compress and the
                    # per-page validation (armed chaos faults stay armed:
                    # nothing fires on a path that never runs)
                    pages.append(self._dense_page(f"{name}+breaker-open", page))
                    self.n_breaker_dense += 1
                    continue
                cm = self._encode(page.reshape(-1, k))
                if plan is not None:
                    f = plan.take(STREAM_KINDS, PAGE_SITE)
                    if f is not None:
                        cm = corrupt_map(cm, f.kind, arg=f.arg)
                        plan.note(f.kind, PAGE_SITE)
                try:
                    validate_map(cm, level=self.validation, site=f"{PAGE_SITE}:{name}")
                except CorruptStream as e:
                    # per-page dense fallback: one page degrades, the
                    # request's other pages stay compressed, and the breaker
                    # counts the detection toward its trip window
                    if self.breaker is not None:
                        self.breaker.record_failure(PAGE_SITE)
                    self.n_recovered += 1
                    print(f"[pool] {e} — page kept dense")
                    pages.append(self._dense_page(name, page))
                    continue
                if self.breaker is not None and self.validation != "off":
                    self.breaker.record_success(PAGE_SITE)
                rec = self.meter.record(name, cm)
                self.bytes_out += rec.measured_bytes
                self.n_pages_out += 1
                pages.append(cm)
            slab.leaves.append(("paged", pages))
            slab.page_shapes.append(page_shape)
        self._slabs[rid] = slab

    def page_in(self, rid):
        """Slab -> dense per-request cache tree (bitwise round trip), in new
        tensors."""
        slab = self._slabs[rid]
        out = []
        for (kind, stored), pshape in zip(slab.leaves, slab.page_shapes):
            if kind == "dense":
                out.append(stored.clone())
                self.bytes_in += self._nbytes(stored)
                continue
            parts = []
            for page in stored:
                if isinstance(page, CompressedMap):
                    parts.append(decompress(page).reshape(pshape))
                    self.bytes_in += page.measured_bytes()
                    self.n_pages_in += 1
                else:                      # dense-fallback page
                    parts.append(page)
                    self.bytes_in += self._nbytes(page)
            out.append(torch.cat(parts, dim=len(pshape) - 3))
        return map_tree(lambda _, i: out[i], slab.template)

    # ------------------------------------------------------------------
    def free(self, rid) -> None:
        self._slabs.pop(rid, None)

    def __contains__(self, rid) -> bool:
        return rid in self._slabs

    def request_bytes(self, rid) -> dict:
        """Per-request KV traffic: measured stream bytes vs the Eq. 2/3
        prediction at each page's measured zero fraction vs dense, plus the
        compressed-page count (the index-padding reconcile bound scales
        with it)."""
        prefix = f"req{rid}/"
        recs = [r for r in self.meter.records if r.site.startswith(prefix)]
        return {
            "measured": sum(r.measured_bytes for r in recs),
            "predicted": sum(r.predicted_bytes for r in recs),
            "dense": sum(r.dense_bytes for r in recs),
            "pages": sum(1 for r in recs if r.compressed),
        }

    def zero_frac(self) -> float:
        """Block-weighted zero fraction across every compressed page."""
        live = sum(r.n_live for r in self.meter.records)
        blocks = sum(r.n_blocks for r in self.meter.records)
        return 1.0 - live / blocks if blocks else 0.0
