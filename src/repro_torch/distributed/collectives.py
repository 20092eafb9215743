"""Compressed collectives (``repro.distributed.collectives``): move the Zebra
(bitmap, payload) stream across a mesh axis instead of the dense map.

A block that is zero in device memory is zero on the interconnect too, so
the interconnect is the same boundary Eq. 2/3 attacks. Every collective
here follows one wire protocol over the ranks of one axis (a
:class:`~repro_torch.distributed.ctx.CommAxis`, whose ranks are the
shards):

1. **Index exchange**: one ``all_gather`` of the ``(nm, nk)`` keep
   bitmaps (int8 flags on the wire; the accounting charges the packed
   index, 1 bit a block, as every transport of the repo does).
2. **Payload exchange**: ``n - 1`` ring hops of ``batch_isend_irecv``;
   each rank sends to the rank after it and receives from the one before
   it in the group's rank order. Over the ring every rank's inbound link
   carries every other shard's stream once. Every rank knows every count
   once the bitmaps are gathered, so a hop sends only the live prefix of
   the consumer-order payload and receives into a worst-case buffer; the
   tail past the count is never read (the expander reads live slots only).
3. **Reconstruction**: each arriving shard is rebuilt from its own bitmap
   (``kernels.pack.zebra_unpack``), so the gather equals a dense
   ``all_gather`` of the masked maps bit for bit; the rank's own shard is
   the map itself.

On the card the pack is kernel 5 (``kernels.pack.zebra_pack``, pack under
a given bitmap) and the rebuild kernel 3 (``zebra_unpack``): an all-gather
launches 1 pack and ``n - 1`` unpacks a rank, a psum 1 of each.

Accounting: ``LinkBytes`` is the (moved, dense-equivalent) pair of one
inbound link, by ``core.engine.stream_bytes``, the rule every compressed
backend uses; ``compress.meter.BandwidthMeter.record_link`` reconciles it
against Eq. 2/3. The reference moves whole worst-case buffers (static
shapes) and accounts the live stream; here the payload bytes a rank
receives over the ring equal the payload part of its ``moved``
(:data:`PAYLOAD_BYTES` counts them).

Validation (a ``compress.integrity`` level) checks every arriving hop; the
ok flags are made uniform over the ring with an ``all_reduce``, and on
any failure the whole ring retries dense (``all_gather``/``all_reduce`` of
the map still in hand), ``integrity.note_failure`` fires once a rank and
the retry's bytes are added to ``moved``.

The transport (:class:`Wire`): ``nccl`` moves card tensors; on a ``gloo``
group (ranks sharing one card, or the CPU) the wire tensors are copied to
host memory and back, since gloo's point-to-point calls take host tensors.
The pack, the rebuild and the checks run on the rank's device either way.

Degrade contract as ``core.engine``'s: a layer exchange runs compressed
only when the site's backend declares the ``comms`` capability and the
axis and shape allow it (:func:`resolve_comms`); otherwise it is a dense
``all_gather`` with the reason logged once and shown on the ``SiteAux``
backend label. The reference's ``shard_map_compat`` and ``axis_size`` are
JAX machinery with no counterpart: the ranks of the group are the shards.
The layer exchanges move values only and carry no gradient: the
reference's train step (``make_train_step``) enters no comm context, so
no reference train path runs them. The tensor-parallel LM's dense collectives (:func:`tp_all_reduce`,
:func:`tp_all_gather`) carry one through ``distributed.ctx``'s autograd
functions, and the sharded train step's data-parallel collectives
(:func:`dp_all_gather`, :func:`dp_mean`, :func:`all_reduce_small`) move
parameters, gradients and the step's global reductions, counted in
:data:`DP_TRAFFIC` with the serving engine's exchanges over ``data``
(the next tokens gathered, a lane broadcast by :func:`dp_broadcast`).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple

import torch

from ..compress import integrity
from ..compress.stream import nonzero_bitmap
from ..core.engine import SiteAux, stream_bytes
from ..ft.inject import ring_hop_tap
from ..kernels.pack import zebra_pack, zebra_unpack
from .ctx import CommAxis, comm_axis

_log = logging.getLogger("repro_torch.collectives")
_DEGRADE_LOGGED: set[tuple[str, str, str]] = set()

RING_SITE = "ring"   # ft.breaker site label of the collectives' hop boundary
# payload bytes this process handed to the ring and took from it
PAYLOAD_BYTES = {"sent": 0, "received": 0}


# ---------------------------------------------------------------------------
# Per-link byte accounting
# ---------------------------------------------------------------------------

class LinkBytes(NamedTuple):
    """Bytes one inbound link of this rank carried for one collective, as
    int64 tensors: ``moved`` what crossed it (the compressed stream, or
    the dense size on a degraded exchange, plus a dense retry's), ``dense``
    what the plain collective of the uncompressed map would move."""
    moved: torch.Tensor
    dense: torch.Tensor


def _i64(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int64, device=device)


def zero_link(device=None) -> LinkBytes:
    return LinkBytes(_i64(0, device), _i64(0, device))


def add_links(a: LinkBytes, b: LinkBytes) -> LinkBytes:
    return LinkBytes(a.moved + b.moved, a.dense + b.dense)


def attach_link(aux: SiteAux, link: LinkBytes, *, reason: str | None = None) -> SiteAux:
    """Fold one exchange's per-link bytes into a ``SiteAux``. A degraded
    (dense) exchange shows its reason on the backend label,
    ``"<backend>+dense-comms(<reason>)"``."""
    label = aux.backend if reason is None else f"{aux.backend}+dense-comms({reason})"
    return dataclasses.replace(aux, ici_bytes=link.moved + aux.ici_bytes,
                               ici_dense_bytes=link.dense + aux.ici_dense_bytes,
                               backend=label)


def dense_link(nbytes_per_shard: int, n: int, device=None) -> LinkBytes:
    """The LinkBytes of a degraded (dense) all-gather: every inbound link
    carries the other ``n - 1`` shards' dense maps."""
    b = _i64((n - 1) * int(nbytes_per_shard), device)
    return LinkBytes(b, b.clone())


# ---------------------------------------------------------------------------
# The transport
# ---------------------------------------------------------------------------

def wire_name(group) -> str:
    """How a group moves card tensors: ``"nccl"``, or ``"gloo (host
    copies)"``."""
    import torch.distributed as dist
    backend = str(dist.get_backend(group))
    return backend if "nccl" in backend else f"{backend} (host copies)"


class Wire:
    """The one place tensors cross a group. On a gloo group a card tensor
    is copied to host memory before it goes and back to its device after
    it arrives; NCCL takes card tensors as they are."""

    def __init__(self, axis: CommAxis):
        import torch.distributed as dist
        if axis.group is None:
            raise ValueError(f"axis {axis.name!r} of {axis.size} shards has no process "
                             f"group: declare comm_context(axis, mesh=...)")
        self.dist, self.axis, self.group = dist, axis, axis.group
        self.host = "nccl" not in str(dist.get_backend(axis.group))
        n, i = axis.size, axis.index
        self.next = dist.get_global_rank(axis.group, (i + 1) % n)
        self.prev = dist.get_global_rank(axis.group, (i - 1) % n)

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.host else t.contiguous()

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(n, *t.shape): every rank's ``t``, in the group's rank order."""
        src = self._out(t).reshape(-1)
        out = src.new_empty(self.axis.size * src.numel())
        self.dist.all_gather_into_tensor(out, src, group=self.group)
        return out.reshape(self.axis.size, *t.shape).to(t.device)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, in a new tensor."""
        buf = self._out(t).clone()
        self.dist.all_reduce(buf, group=self.group)
        return buf.to(t.device)

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``t`` (its index in the group) on every rank, in a
        new tensor; ``t`` gives the others its shape and dtype."""
        buf = self._out(t).clone()
        self.dist.broadcast(buf, self.dist.get_global_rank(self.group, src), group=self.group)
        return buf.to(t.device)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, this rank's chunk of dim 0 (the
        dense counterpart of ``zebra_reduce_scatter``)."""
        src = self._out(t)
        out = src.new_empty((t.shape[0] // self.axis.size, *t.shape[1:]))
        self.dist.reduce_scatter_tensor(out, src, group=self.group)
        return out.to(t.device)

    def hop(self, send: torch.Tensor, recv: torch.Tensor) -> None:
        """One ring hop: ``send`` to the next rank, the previous rank's
        tensor into ``recv`` (same dtype; the sizes every rank knows).
        An empty side is skipped, as its peer skips it."""
        ops, back = [], None
        d = self.dist
        if send.numel():
            ops.append(d.P2POp(d.isend, self._out(send), self.next, self.group))
        if recv.numel():
            back = torch.empty(recv.shape, dtype=recv.dtype) if self.host else recv
            ops.append(d.P2POp(d.irecv, back, self.prev, self.group))
        if ops:
            for w in d.batch_isend_irecv(ops):
                w.wait()
        if back is not None and back is not recv:
            recv.copy_(back)
        PAYLOAD_BYTES["sent"] += send.numel() * send.element_size()
        PAYLOAD_BYTES["received"] += recv.numel() * recv.element_size()


def gather_dense(t: torch.Tensor, axis: CommAxis) -> torch.Tensor:
    """(n, *t.shape): the plain all-gather a degraded exchange runs."""
    return t[None] if axis.size == 1 else Wire(axis).all_gather(t)


# ---------------------------------------------------------------------------
# The tensor-parallel LM's dense collectives
# ---------------------------------------------------------------------------

# calls and the bytes each rank handed in, of the tensor-parallel LM's dense
# collectives (the row-parallel sums, the site, K/V and logit gathers), and
# of the sums its backward runs (``bwd_``: the copies into the
# tensor-parallel region, ``distributed.ctx.copy_model``)
TP_TRAFFIC = {"calls": 0, "bytes": 0, "bwd_calls": 0, "bwd_bytes": 0}


def _tp_count(t: torch.Tensor, backward: bool = False) -> None:
    pre = "bwd_" if backward else ""
    TP_TRAFFIC[pre + "calls"] += 1
    TP_TRAFFIC[pre + "bytes"] += t.numel() * t.element_size()


def tp_all_reduce(t: torch.Tensor, axis: CommAxis, *, backward: bool = False) -> torch.Tensor:
    """The sum over ``axis`` of a row-parallel product's partial sums, in
    ``t``'s dtype. A 16-bit tensor is summed in float32 and rounded once:
    gloo's sums of 16-bit values round after every add. Every rank gets the
    same bytes (the collective hands each rank the one reduced buffer).
    ``backward``: counted as a backward's sum."""
    _tp_count(t, backward)
    wide = t if t.element_size() >= 4 else t.float()
    return Wire(axis).all_reduce(wide).to(t.dtype)


def tp_all_gather(t: torch.Tensor, axis: CommAxis, dim: int) -> torch.Tensor:
    """Every rank's ``t`` of ``axis`` concatenated along ``dim``, in the
    group's rank order."""
    _tp_count(t)
    g = Wire(axis).all_gather(t.contiguous())                 # (n, *t.shape)
    return torch.cat(g.unbind(0), dim=dim)


# ---------------------------------------------------------------------------
# The data-parallel collectives
# ---------------------------------------------------------------------------

# calls and the bytes each rank handed in, of the sharded train step's
# collectives outside the model (the parameters' gather over ``data``, the
# gradients' reduction and the step's global maxima, norms and metrics)
# and of the serving engine's over ``data`` (tokens gathered, lanes
# broadcast)
DP_TRAFFIC = {"calls": 0, "bytes": 0}
DP_CHUNK = 1 << 24      # elements an all-reduce moves at a time: its host copies' bound


def _dp_count(t: torch.Tensor) -> None:
    DP_TRAFFIC["calls"] += 1
    DP_TRAFFIC["bytes"] += t.numel() * t.element_size()


def dp_all_gather(shard: torch.Tensor, axis: CommAxis, dim: int) -> torch.Tensor:
    """Every rank's ``shard`` of ``axis`` concatenated along ``dim`` in rank
    order (an FSDP parameter made whole over ``data``)."""
    if axis.size == 1:
        return shard
    _dp_count(shard)
    g = Wire(axis).all_gather(shard.contiguous())
    return torch.cat(g.unbind(0), dim=dim)


def dp_broadcast(tensors: list, axis: CommAxis, src: int) -> list:
    """Rank ``src``'s ``tensors`` (its index in ``axis``) on every rank of
    ``axis``, in one broadcast of their bytes; the other ranks' tensors
    give only the shapes and dtypes (a lane of the serving engine's hot
    set copied from the data rank that holds it)."""
    if axis.size == 1:
        return tensors
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])
    _dp_count(flat)
    flat = Wire(axis).broadcast(flat, src)
    out, at = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        out.append(flat[at:at + n].clone().view(t.dtype).reshape(t.shape))
        at += n
    return out


def dp_mean(g: torch.Tensor, axis: CommAxis, dim: int | None) -> torch.Tensor:
    """The mean over ``axis`` of every rank's float32 ``g``: with ``dim``,
    this rank's chunk of it along ``dim`` (a reduce-scatter: the leaf is
    split over ``axis`` there); with None the whole mean (an all-reduce,
    ``DP_CHUNK`` elements at a time). The sum is float32, then divided by
    the rank count."""
    if g.dtype != torch.float32:
        raise ValueError(f"dp_mean sums float32 gradients, got {g.dtype}")
    n = axis.size
    if n == 1:
        return g
    wire = Wire(axis)
    if dim is None:
        out = torch.empty_like(g)
        for src, dst in zip(g.reshape(-1).split(DP_CHUNK), out.view(-1).split(DP_CHUNK)):
            _dp_count(src)
            dst.copy_(wire.all_reduce(src))
        return out.div_(n)
    _dp_count(g)
    front = g.movedim(dim, 0).contiguous()
    return wire.reduce_scatter(front).div_(n).movedim(0, dim).contiguous()


def all_reduce_small(t: torch.Tensor, axis: CommAxis, op: str = "sum") -> torch.Tensor:
    """``t`` (a few values: metrics, maxima, norms) reduced over ``axis``
    by ``op`` (``"sum"`` or ``"max"``), the same bytes on every rank."""
    if axis.size == 1:
        return t
    import torch.distributed as dist
    _dp_count(t)
    wire = Wire(axis)
    buf = wire._out(t).clone()
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                    group=axis.group)
    return buf.to(t.device)


# ---------------------------------------------------------------------------
# zebra_all_gather: the compressed sequence-parallel activation exchange
# ---------------------------------------------------------------------------

def _check_shard(x2: torch.Tensor, bs: int, bc: int, what: str) -> tuple[int, int]:
    M, K = x2.shape
    if M % bs or K % bc:
        raise ValueError(f"{what}: shard ({M}, {K}) not divisible by blocks ({bs}, {bc}) "
                         f"(resolve_comms degrades such an exchange to dense)")
    return M // bs, K // bc


def _ring_ok(ok: torch.Tensor, wire: Wire) -> bool:
    """Every rank's verdict, made uniform: one corrupt hop anywhere fails
    the whole ring."""
    return int(wire.all_reduce(ok.to(torch.int64))) == wire.axis.size


def zebra_all_gather(x2: torch.Tensor, axis: CommAxis, *, bs: int, bc: int,
                     bitmap: torch.Tensor | None = None, tiled: bool = False,
                     validation: str = "off", live_nonzero: bool = True,
                     site: str = "all_gather") -> tuple[torch.Tensor, LinkBytes]:
    """All-gather a block-sparse (M, K) shard in Zebra stream form.

    Returns ``(gathered, LinkBytes)``: ``(n, M, K)`` in the group's rank
    order (``(n*M, K)`` with ``tiled``), equal to a dense all-gather
    whenever each shard's dead blocks (under its bitmap; by default its
    nonzero blocks) are exact zeros, and the per-inbound-link bytes::

        moved = sum_{s != self} n_live_s * bs * bc * itemsize + ceil(nm*nk / 8)
        dense = (n - 1) * M * K * itemsize
    """
    nm, nk = _check_shard(x2, bs, bc, "zebra_all_gather")
    M, K = x2.shape
    n, idx = axis.size, axis.index
    if bitmap is None:
        bitmap = nonzero_bitmap(x2, bs, bc)
    if n == 1:
        return (x2 if tiled else x2[None]), zero_link(x2.device)
    wire = Wire(axis)
    tag = f"ring:{site}"
    payload, n_live = zebra_pack(x2, bitmap, bs=bs, bc=bc)
    bitmaps = wire.all_gather((bitmap != 0).to(torch.int8))            # (n, nm, nk)
    counts_t = bitmaps.reshape(n, -1).sum(dim=1, dtype=torch.int64)
    counts = counts_t.tolist()
    csums = (wire.all_gather(integrity.stream_checksum(payload, bitmap, n_live))
             if validation == "checksum" else None)
    out = x2.new_empty((n, M, K))
    out[idx] = x2
    ok = torch.ones((), dtype=torch.bool, device=x2.device)
    held, spare = payload, torch.empty_like(payload)
    for h in range(1, n):
        # after hop h this rank holds shard (idx - h) % n
        src, fwd = (idx - h) % n, (idx - h + 1) % n
        wire.hop(held[:counts[fwd]], spare[:counts[src]])
        arrived = ring_hop_tap(spare, h, site=tag)
        if validation != "off":
            ok = ok & integrity.check_stream(
                arrived, bitmaps[src], counts[src], level=validation,
                checksum=None if csums is None else csums[src], live_nonzero=live_nonzero)
        out[src] = zebra_unpack(arrived, bitmaps[src], bs=bs, bc=bc)
        held, spare = arrived, held
    streams = stream_bytes(counts_t, bs, bc, x2.dtype, nm * nk)
    moved = streams.sum() - streams[idx]
    dense = _i64((n - 1) * M * K * x2.element_size(), x2.device)
    if validation != "off" and not _ring_ok(ok, wire):
        integrity.note_failure(tag)
        out = wire.all_gather(x2)
        moved = moved + dense
    return (out.reshape(n * M, K) if tiled else out), LinkBytes(moved, dense)


# ---------------------------------------------------------------------------
# zebra_psum_stream / zebra_reduce_scatter: reductions in payload form
# ---------------------------------------------------------------------------

def zebra_psum_stream(g2: torch.Tensor, axis: CommAxis, *, bs: int, bc: int,
                      bitmap: torch.Tensor | None = None, validation: str = "off",
                      site: str = "psum") -> tuple[torch.Tensor, torch.Tensor, LinkBytes]:
    """Sum of the ranks' block-sparse maps that never densifies in flight.

    The gathered bitmaps' union sets the payload's layout: every rank
    packs its map at the union (its own dead blocks give exact-zero
    slots), so arriving payloads add slot for slot and the sum is expanded
    once. The order is the reference's ring order: the rank's own payload,
    then the one arriving at hop 1, 2, ...; the float result equals the
    reference's bit for bit on any data (and a tree-ordered all-reduce
    only on data whose sums are exact, integer-valued for instance).

    Returns ``(summed map, union bitmap, LinkBytes)`` with::

        moved = (n - 1) * (union_live * bs * bc * itemsize + ceil(nm*nk / 8))
        dense = (n - 1) * M * K * itemsize

    ``validation`` checks each arriving payload before it is added; a
    zeroed union-capacity payload is structurally legal (a union slot may
    be zero on one rank), so ``checksum`` is the level that sees a dropped
    hop. A failure makes the ring retry as a dense ``all_reduce``."""
    nm, nk = _check_shard(g2, bs, bc, "zebra_psum_stream")
    M, K = g2.shape
    n, idx = axis.size, axis.index
    if bitmap is None:
        bitmap = nonzero_bitmap(g2, bs, bc)
    if n == 1:
        return g2, (bitmap != 0).to(torch.int8), zero_link(g2.device)
    wire = Wire(axis)
    tag = f"ring:{site}"
    bitmaps = wire.all_gather((bitmap != 0).to(torch.int8))
    union = (bitmaps.sum(dim=0) > 0).to(torch.int8)
    payload, u_live_t = zebra_pack(g2, union, bs=bs, bc=bc)
    u_live = int(u_live_t)
    csums = (wire.all_gather(integrity.stream_checksum(payload, union, u_live_t))
             if validation == "checksum" else None)
    acc = payload.clone()
    ok = torch.ones((), dtype=torch.bool, device=g2.device)
    held, spare = payload, torch.empty_like(payload)
    for h in range(1, n):
        wire.hop(held[:u_live], spare[:u_live])
        arrived = ring_hop_tap(spare, h, site=tag)
        if validation != "off":
            ok = ok & integrity.check_stream(
                arrived, union, u_live, level=validation,
                checksum=None if csums is None else csums[(idx - h) % n],
                live_nonzero=False)
        acc[:u_live] += arrived[:u_live]
        held, spare = arrived, held
    y = zebra_unpack(acc, union, bs=bs, bc=bc)
    moved = (n - 1) * stream_bytes(u_live_t, bs, bc, g2.dtype, nm * nk)
    dense = _i64((n - 1) * M * K * g2.element_size(), g2.device)
    if validation != "off" and not _ring_ok(ok, wire):
        integrity.note_failure(tag)
        y = wire.all_reduce(g2)
        moved = moved + dense
    return y, union, LinkBytes(moved, dense)


def zebra_reduce_scatter(g2: torch.Tensor, axis: CommAxis, *, bs: int, bc: int,
                         bitmap: torch.Tensor | None = None, validation: str = "off",
                         site: str = "reduce_scatter") -> tuple[torch.Tensor, LinkBytes]:
    """Reduce-scatter over block rows: the psum in payload form, then this
    rank's ``M // n`` row chunk (bs-aligned, so no chunk splits a block).
    Accounted as a ring reduce-scatter: each inbound link carries the
    travelling partial of every chunk but the home one, at union capacity
    restricted to that chunk's block rows::

        moved = sum_{c != home} (union_live_c * bs * bc * itemsize + ceil(nb_c / 8))
        dense = (n - 1) * (M // n) * K * itemsize
    """
    M, K = g2.shape
    n, idx = axis.size, axis.index
    if n == 1:
        return g2, zero_link(g2.device)
    if M % (n * bs):
        raise ValueError(f"zebra_reduce_scatter: M={M} must split into {n} bs-aligned "
                         f"chunks (bs={bs}); resolve_comms degrades such an exchange")
    Ml = M // n
    y, union, _ = zebra_psum_stream(g2, axis, bs=bs, bc=bc, bitmap=bitmap,
                                    validation=validation, site=site)
    nm_l, nk = Ml // bs, K // bc
    chunk_counts = union.reshape(n, nm_l, nk).sum(dim=(1, 2), dtype=torch.int64)
    chunk_streams = stream_bytes(chunk_counts, bs, bc, g2.dtype, nm_l * nk)
    moved = chunk_streams.sum() - chunk_streams[idx]
    dense = _i64((n - 1) * Ml * K * g2.element_size(), g2.device)
    return y[idx * Ml:(idx + 1) * Ml], LinkBytes(moved, dense)


# ---------------------------------------------------------------------------
# Exact reductions of per-shard observables (the data-parallel MoE, meters)
# ---------------------------------------------------------------------------

def psum_exact_bytes(nbytes, axis: CommAxis) -> torch.Tensor:
    """The exact int64 sum of the ranks' byte counts over ``axis``. The
    reference splits int32 legs at 2**16 and returns a float32 base-2**24
    pair, because JAX runs 32-bit; an int64 all-reduce is exact to 2**63
    as it is."""
    return Wire(axis).all_reduce(torch.as_tensor(nbytes).to(torch.int64))


class _ShardMean(torch.autograd.Function):
    """The mean over the ranks of ``axis``, gathered and summed in rank
    order. The reference's ``pmean`` differentiates: each rank's value
    gets the sum over the ranks of the mean's gradient, divided by their
    count. Every rank's consumer of the mean is replicated (each rank's
    loss holds the same mean), so that is the rank's own gradient, passed
    through."""

    @staticmethod
    def forward(ctx, values, axis):
        rows = Wire(axis).all_gather(values)
        acc = rows[0]
        for r in rows[1:]:
            acc = acc + r
        return acc / axis.size

    @staticmethod
    def backward(ctx, g):
        return g, None


def shard_mean(values: torch.Tensor, axis: CommAxis) -> torch.Tensor:
    """The mean over the ranks of ``axis`` of a float32 vector: gathered,
    summed in rank order, divided by the rank count (the reference's
    ``pmean``, with its gradient: :class:`_ShardMean`). Every rank gets
    the same bits."""
    return _ShardMean.apply(values.to(torch.float32), axis)


# ---------------------------------------------------------------------------
# Capability resolution for layer exchanges
# ---------------------------------------------------------------------------

def resolve_comms(backend_name: str, *, rows: int, cols: int, bs: int, bc: int
                  ) -> tuple[str | None, str | None]:
    """How a layer exchange runs: ``("compressed", None)``, ``("dense",
    reason)``, or ``(None, None)`` with no comm context (no exchange: the
    single-process semantics). The site's backend must declare
    ``comms="compressed"`` (``core.backends``), the axis must be sharded,
    the shard must tile into whole (bs, bc) blocks, and the ring's breaker
    (``ft.breaker``, site :data:`RING_SITE`) must be closed; anything else
    is a dense all-gather with its reason."""
    info = comm_axis()
    if info is None:
        return None, None
    from ..core.backends import backend_spec
    from ..ft.breaker import active_board
    if backend_spec(backend_name).comms != "compressed":
        return "dense", "comms-capability"
    if info.size <= 1:
        return "dense", "single-device"
    if rows % bs or cols % bc:
        return "dense", "non-divisible"
    board = active_board()
    if board is not None and not board.allow(RING_SITE):
        return "dense", "breaker-open"
    return "compressed", None


def log_comm_degrade(site: str, backend: str, reason: str) -> None:
    key = (site, backend, reason)
    if key not in _DEGRADE_LOGGED:
        _DEGRADE_LOGGED.add(key)
        _log.info("compressed comms at %r: backend %r degraded to a dense all_gather "
                  "(%s)", site, backend, reason)
