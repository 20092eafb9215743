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

Under tensor parallelism (``tp``, the engine's model cut for a mesh) each
rank pages its own K/V heads, and the pool meters the pages
the reference's pool meters, those of the whole cache. A page's block
geometry comes from the whole page (``Hkv*hd`` of every head: a rank
taking its own width would fall back to other blocks). Its rule is the
tensor-parallel handoff's (``compress.stream.pack_plan``): a rank's heads
on block edges are packed as they are (kernel 5 on each rank's part),
replicated heads are packed whole on every rank, and heads that cut a
block are gathered over ``model`` (one gather for every such leaf of the
call), packed whole and expanded whole at page in, each rank keeping its
part (``CompressedMap.part``). Each page goes on the meter once, with the
whole page's counts: its live blocks summed over the ranks that own them,
in one all-reduce a ``page_out`` call for all its pages, which also
carries every page's ingest verdict, so a page that fails validation on
any rank is kept dense on every rank. The verdict of a page the ranks
hold in parts can differ between ranks only under an armed fault plan (a
``truncate`` of a part with no live block passes there); the breaker
must hear the agreed verdict before the next page consults it, so such a
call agrees each page's verdict before the next page (one all-reduce a
page, in chaos runs alone). ``page_in`` needs no collective. Over
``data`` the pool is replicated: every data rank makes the same calls on
the same tensors (``serve.engine``), and nothing here crosses ``data``.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Any

import torch

from ..compress import BandwidthMeter, CompressedMap, compress, decompress
from ..compress.stream import pack_plan
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
        self.page_bytes: list[list[int] | None] = []   # each page's metered bytes


class PagedKVPool:
    """Compressed page-in/page-out store keyed by request id.

    ``page_out(rid, caches)`` replaces any previous slab for ``rid``: the
    stream is re-emitted and re-metered (eviction traffic is real
    traffic). ``page_in(rid)`` decompresses the slab back to the dense
    per-request tree, bitwise equal to what was paged out (pages that
    failed ingest validation were kept dense, so bitwise equal too). The
    device of each page decides the codec's route, as ``compress`` does.
    ``tp`` (a ``distributed.ctx.TensorParallel``) and
    ``kv_heads`` (the whole model's K/V heads) page a rank's head shards
    (module docstring).
    """

    def __init__(self, *, page_tokens: int = 16, bs: int = 8, bc: int = 128,
                 validation: str = "off", breaker=None, tp=None, kv_heads: int = 0):
        if page_tokens & (page_tokens - 1) or page_tokens < 1:
            raise ValueError(f"page_tokens must be a power of two, got {page_tokens}")
        self.page_tokens = page_tokens
        self.bs, self.bc = bs, bc
        self.validation = validate_level(validation)
        self.breaker = breaker    # ft.breaker.BreakerBoard | None: the
                                  # page-ingest circuit; open means pages
                                  # skip compress and validation wholesale
        self.tp, self.kv_heads = tp, kv_heads
        self.meter = BandwidthMeter()
        self._slabs: dict[Any, _Slab] = {}
        self.n_pages_out = 0
        self.n_pages_in = 0
        self.n_recovered = 0      # corrupt pages kept dense at ingest
        self.n_breaker_dense = 0  # pages sent dense by an open breaker
        self.bytes_out = 0        # stream bytes written to the pool
        self.bytes_in = 0         # stream bytes read back out
        self.seconds_out = 0.0    # host time in page_out / page_in
        self.seconds_in = 0.0

    # ------------------------------------------------------------------
    def _eff_blocks(self, m: int, k: int) -> tuple[int, int]:
        """eff_block_ch-style divisor fallback, so pages compress even when
        the reduced head dims do not divide the configured blocks."""
        bs = self.bs if m % self.bs == 0 else 1
        bc = self.bc if k % self.bc == 0 else k
        return bs, bc

    @staticmethod
    def _pageable(leaf) -> bool:
        """Attention cache leaves: (..., B, T, Hkv, hd), T at axis -3 (the
        ``model_prefill_pad`` convention)."""
        return (isinstance(leaf, torch.Tensor) and leaf.dim() >= 4
                and leaf.is_floating_point())

    def _whole(self, leaf) -> int:
        """How many times ``leaf``'s columns the whole cache's are: the
        model axis's size for K/V heads split over it, else 1."""
        if self.tp is None or leaf.shape[-2] == self.kv_heads:
            return 1
        return self.tp.model.size

    # ------------------------------------------------------------------
    def page_out(self, rid, caches) -> None:
        """Compress a per-request cache tree into the slab store. The ingest
        boundary: an armed chaos plan (``ft.inject``) with a stream fault at
        site ``"page"`` corrupts pages here, after compression and before
        validation, and a page that fails ``validate_map`` is kept dense
        (per-page fallback)."""
        t0 = time.perf_counter()
        leaves = []
        count = itertools.count()

        def index(_, leaf):
            leaves.append(leaf)
            return next(count)
        slab = _Slab(map_tree(index, caches))
        pt = self.page_tokens
        plans = []                      # per leaf: None (dense) or its packing
        for leaf in leaves:
            T = leaf.shape[-3] if self._pageable(leaf) else 0
            if not T or T % pt:
                plans.append(None)
                continue
            n = self._whole(leaf)
            rows = math.prod(leaf.shape[:-3]) * pt
            bs, bc = self._eff_blocks(rows, math.prod(leaf.shape[-2:]) * n)
            gathers, owned = [], True
            if self.tp is not None:
                gathers, owned = pack_plan(leaf.shape, ((self.tp.model, -2, n > 1),), 2,
                                           bs, bc)
            plans.append({"bs": bs, "bc": bc, "gather": bool(gathers), "owned": owned,
                          "n": n})
        whole = self._gather([leaf for leaf, p in zip(leaves, plans) if p and p["gather"]])
        work = []                       # (leaf index, page index, page, map source)
        for i, (leaf, p) in enumerate(zip(leaves, plans)):
            if p is None:
                continue
            src = whole.pop(0) if p["gather"] else leaf
            ax = leaf.dim() - 3
            for j in range(leaf.shape[ax] // pt):
                work.append((i, j, leaf.narrow(ax, j * pt, pt), src.narrow(ax, j * pt, pt)))
        plan = active_plan()
        split = any(p and not p["gather"] and p["n"] > 1 for p in plans)
        each = (self.tp is not None and split and plan is not None
                and self.validation != "off")
        outs = [self._page(rid, i, j, src, plans[i], plan, each) for i, j, _, src in work]
        if self.tp is not None and not each:
            self._agree(outs)
        done = iter(zip(work, outs))
        for i, (leaf, p) in enumerate(zip(leaves, plans)):
            if p is None:
                slab.leaves.append(("dense", leaf.clone()))
                slab.page_shapes.append(None)
                slab.page_bytes.append(None)
                nbytes = self._nbytes(leaf) * self._whole(leaf)
                self.meter.record_dense(f"req{rid}/leaf{i}", nbytes)
                self.bytes_out += nbytes
                continue
            stored = [self._commit(rid, i, j, page, p, *out)
                      for (_, j, page, _), out in itertools.islice(done, leaf.shape[-3] // pt)]
            slab.leaves.append(("paged", [s for s, _ in stored]))
            slab.page_shapes.append(tuple(leaf.shape[:-3]) + (pt,) + tuple(leaf.shape[-2:]))
            slab.page_bytes.append([b for _, b in stored])
        self._slabs[rid] = slab
        self.seconds_out += time.perf_counter() - t0

    def _gather(self, leaves: list) -> list:
        """``leaves`` (this rank's heads) with every model rank's heads, in
        one all-gather."""
        if not leaves:
            return []
        from ..distributed.collectives import tp_all_gather
        flat = torch.cat([x.reshape(-1) for x in leaves])
        g = tp_all_gather(flat[None], self.tp.model, 0)          # (m, total)
        out, at = [], 0
        for x in leaves:
            part = g[:, at:at + x.numel()].reshape(g.shape[0], *x.shape)
            at += x.numel()
            out.append(torch.cat(part.unbind(0), dim=-2))
        return out

    def _page(self, rid, i: int, j: int, src, p: dict, plan, each: bool):
        """One page's ingest: (CompressedMap, or None for a page the open
        breaker sends dense; this rank's live blocks of it; its verdict),
        the breaker told the verdict. With ``each`` the model ranks agree
        the page's live blocks and verdict before the breaker hears it."""
        name = f"req{rid}/leaf{i}/pg{j}"
        if self.breaker is not None and not self.breaker.allow(PAGE_SITE):
            # circuit open: the compressed path at this boundary is sick,
            # so dense wholesale, skipping compress and the per-page
            # validation (armed chaos faults stay armed: nothing fires on a
            # path that never runs)
            return None, 0, False
        cm = compress(src.reshape(-1, src.shape[-2] * src.shape[-1]), bs=p["bs"],
                      bc=p["bc"], checksum=(self.validation == "checksum"))
        if p["gather"]:
            n = cm.k // p["n"]
            cm = dataclasses.replace(cm, part=((1, self.tp.model.index * n, n),))
        if plan is not None:
            f = plan.take(STREAM_KINDS, PAGE_SITE)
            if f is not None:
                cm = corrupt_map(cm, f.kind, arg=f.arg)
                plan.note(f.kind, PAGE_SITE)
        bad = False
        try:
            validate_map(cm, level=self.validation, site=f"{PAGE_SITE}:{name}")
        except CorruptStream as e:
            bad = True
            print(f"[pool] {e} — page kept dense")
        live = None                     # one process meters the map itself
        if self.tp is not None:
            live = cm.n_live.to(torch.int64) if p["owned"] else torch.zeros(
                (), dtype=torch.int64, device=cm.n_live.device)
        if each:
            from ..distributed.collectives import tp_all_reduce
            live, vote = tp_all_reduce(torch.stack([live, torch.full_like(live, int(bad))]),
                                       self.tp.model).tolist()
            bad = vote > 0
        if self.breaker is not None:
            if bad:
                # per-page dense fallback: one page degrades, the request's
                # other pages stay compressed, and the breaker counts the
                # detection toward its trip window
                self.breaker.record_failure(PAGE_SITE)
            elif self.validation != "off":
                self.breaker.record_success(PAGE_SITE)
        return cm, live, bad

    def _agree(self, outs: list) -> None:
        """Every page's live blocks summed over the model ranks that own
        them, in one all-reduce that also counts the ranks whose page
        failed validation, in place in ``outs``. The breaker heard each
        rank's own verdicts page by page; a verdict the ranks split on
        could not have been heard alike, and raises (it takes a fault
        plan, which agrees page by page)."""
        from ..distributed.collectives import tp_all_reduce
        at = [k for k, (cm, _, _) in enumerate(outs) if cm is not None]
        if not at:
            return
        lives = [outs[k][1] for k in at]
        votes = [torch.full_like(lives[0], int(outs[k][2])) for k in at]
        got = tp_all_reduce(torch.stack(lives + votes), self.tp.model).tolist()
        for k, live, vote in zip(at, got[:len(at)], got[len(at):]):
            cm, _, bad = outs[k]
            if vote not in (0, self.tp.model.size):
                raise RuntimeError(f"the model ranks split on page {k}'s ingest verdict")
            outs[k] = (cm, live, bad)

    def _commit(self, rid, i: int, j: int, page, p: dict, cm, live, bad):
        """Store one page and meter it: (stored page, its metered bytes)."""
        name = f"req{rid}/leaf{i}/pg{j}"
        if cm is None:
            self.n_breaker_dense += 1
            return self._dense_page(f"{name}+breaker-open", page, p["n"])
        if bad:
            self.n_recovered += 1
            return self._dense_page(name, page, p["n"])
        if self.tp is None:
            rec = self.meter.record(name, cm)
        else:
            k = cm.k if p["gather"] else cm.k * p["n"]      # the whole page's columns
            rec = self.meter.record_counts(name, m=cm.m, k=k, bs=cm.bs, bc=cm.bc,
                                           itemsize=cm.itemsize, n_live=int(live))
        self.bytes_out += rec.measured_bytes
        self.n_pages_out += 1
        return cm, rec.measured_bytes

    @staticmethod
    def _nbytes(t: torch.Tensor) -> int:
        return t.numel() * t.element_size()

    def _dense_page(self, name: str, page: torch.Tensor, n: int = 1):
        dense = page.clone()
        nbytes = self._nbytes(dense) * n
        self.meter.record_dense(name, nbytes)
        self.bytes_out += nbytes
        return dense, nbytes

    def page_in(self, rid):
        """Slab -> dense per-request cache tree (bitwise round trip), in new
        tensors."""
        t0 = time.perf_counter()
        slab = self._slabs[rid]
        out = []
        for (kind, stored), pshape, nbytes in zip(slab.leaves, slab.page_shapes,
                                                  slab.page_bytes):
            if kind == "dense":
                out.append(stored.clone())
                self.bytes_in += self._nbytes(stored) * self._whole(stored)
                continue
            parts = []
            for page, nb in zip(stored, nbytes):
                if isinstance(page, CompressedMap):
                    parts.append(decompress(page).reshape(pshape))
                    self.n_pages_in += 1
                else:                      # dense-fallback page
                    parts.append(page)
                self.bytes_in += nb
            out.append(torch.cat(parts, dim=len(pshape) - 3))
        self.seconds_in += time.perf_counter() - t0
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
