"""Deterministic fault injection (``repro.ft.inject``): the chaos harness
behind the integrity claims.

Faults are declared as data (:class:`Fault`), armed with :func:`inject`,
and fire at taps on the stream paths:

* :func:`stream_tap` sits where the engine has the raw ``(payload, bitmap,
  n_live)`` triple in hand (between the producer and the check) and
  corrupts it on the stream's device;
* :func:`ring_hop_tap` sits in the collectives' ring loop
  (``distributed.collectives``) and zeroes the payload that arrives at one
  chosen hop;
* :func:`corrupt_map` corrupts a ``CompressedMap`` (serve's prefill ->
  decode handoff).

Three act outside the stream: :func:`corrupt_file` flips a byte of a file
on disk (a checkpoint shard), :func:`crashing_step` makes a step function
raise at a given call (the supervisor's restore path), and
:func:`crash_tap` kills the serving engine's tick loop at a named tick
(``Fault("crash", site=ENGINE_TICK_SITE, arg=tick)``).

A fault names its target position (``arg``) outright, so a run injects
the same corruption every time. PyTorch runs eagerly, so a tap consults
the armed plan at every call; with no plan armed it returns its inputs
and launches nothing.

Fault kinds over one stream (all detected by ``compress.integrity``):

=============  ==========================================================
``bitflip``    flip bitmap bit ``arg`` (popcount no longer matches
               ``n_live``, and the consumer slot map would shift)
``truncate``   zero the last live payload slot (a cut-short transfer)
``nan``        poison element (0, 0) of live slot ``arg`` with NaN
``value``      add 1.0 to element (0, 0) of live slot ``arg``: still
               finite and nonzero, so only the checksum level sees it
``count``      ``n_live += 1`` (a corrupt counter; popcount mismatch)
``drop_hop``   zero the payload arriving at ring hop ``arg``
               (:func:`ring_hop_tap` only)
=============  ==========================================================
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Iterator

import torch

from .faults import TransientStep

STREAM_KINDS = ("bitflip", "truncate", "nan", "value", "count")
HOP_KINDS = ("drop_hop",)
CRASH_KINDS = ("crash",)
ENGINE_TICK_SITE = "engine_tick"   # crash_tap's site in the serve loop


@dataclasses.dataclass
class Fault:
    """One declared fault. ``site`` matches the tap's site label (``"*"``
    = any tap); ``arg`` picks the position (bit index, live slot);
    ``times`` is how many taps it fires at (-1 = every matching tap)."""
    kind: str
    site: str = "*"
    arg: int = 0
    times: int = 1


class FaultPlan:
    """The armed set of faults plus the record of what actually fired.
    ``injected`` is the ground truth a chaos run compares against
    ``integrity.failures()``: detection must be 1:1 with injection."""

    def __init__(self, faults: list[Fault]):
        self.faults = list(faults)
        self._remaining = [f.times for f in self.faults]
        self.injected: list[tuple[str, str]] = []

    def take(self, kinds: tuple[str, ...], site: str,
             arg: int | None = None) -> Fault | None:
        """Consume the first live fault matching this tap, or None.
        ``arg`` additionally requires an exact ``f.arg`` match."""
        for i, f in enumerate(self.faults):
            if f.kind not in kinds or self._remaining[i] == 0:
                continue
            if f.site != "*" and f.site != site:
                continue
            if arg is not None and f.arg != arg:
                continue
            if self._remaining[i] > 0:
                self._remaining[i] -= 1
            return f
        return None

    def note(self, kind: str, site: str) -> None:
        self.injected.append((kind, site))


_ACTIVE: contextvars.ContextVar[FaultPlan | None] = \
    contextvars.ContextVar("repro_torch_fault_plan", default=None)


def active_plan() -> FaultPlan | None:
    return _ACTIVE.get()


@contextlib.contextmanager
def inject(*faults: Fault) -> Iterator[FaultPlan]:
    """Arm a fault plan for the dynamic extent of the block."""
    plan = FaultPlan(list(faults))
    tok = _ACTIVE.set(plan)
    try:
        yield plan
    finally:
        _ACTIVE.reset(tok)


# ---------------------------------------------------------------------------
# Corruption of an in-flight stream (on its device, no host read)
# ---------------------------------------------------------------------------

def _corrupt_stream(payload: torch.Tensor, bitmap: torch.Tensor,
                    n_live: torch.Tensor, kind: str, arg: int):
    """Apply one fault kind to a (payload, bitmap, n_live) triple, into
    new tensors. Every corruption is guarded to bite: a NaN written into a
    dead slot would be invisible, and would falsely fail the
    detected-iff-injected assertion."""
    nb = payload.shape[0]
    nl = n_live.to(torch.int32)
    if kind == "bitflip":
        flat = bitmap.reshape(-1).clone()
        pos = int(arg) % flat.numel()
        flat[pos] = 1 - flat[pos]
        return payload, flat.reshape(bitmap.shape), n_live
    if kind == "count":
        return payload, bitmap, nl + 1
    if kind == "truncate":
        last = torch.clamp(nl - 1, min=0)
        hit = torch.arange(nb, dtype=torch.int32, device=payload.device)[:, None, None] == last
        return torch.where(hit & (nl > 0), torch.zeros_like(payload), payload), bitmap, n_live
    if kind in ("nan", "value"):
        # a one-element index: the read and the write stay on the device
        slot = torch.where(nl > 0, torch.clamp(nl - 1, max=int(arg)),
                           torch.zeros_like(nl)).to(torch.int64).reshape(1)
        old = payload[slot, 0, 0]
        bad = (torch.full_like(old, float("nan")) if kind == "nan"
               else old + torch.ones_like(old))
        out = payload.clone()
        out[slot, 0, 0] = torch.where(nl > 0, bad, old)
        return out, bitmap, n_live
    raise ValueError(f"unknown stream fault kind {kind!r}")


def stream_tap(payload: torch.Tensor, bitmap: torch.Tensor, n_live: torch.Tensor,
               *, site: str):
    """Corruption point for one in-flight stream: returns its inputs
    unless a matching fault is armed."""
    plan = active_plan()
    if plan is None:
        return payload, bitmap, n_live
    applied: set[int] = set()
    while True:
        f = plan.take(STREAM_KINDS, site)
        # each armed fault fires at most once per tap call: a times=-1
        # fault is returned by take() forever
        if f is None or id(f) in applied:
            return payload, bitmap, n_live
        applied.add(id(f))
        payload, bitmap, n_live = _corrupt_stream(payload, bitmap, n_live, f.kind, f.arg)
        plan.note(f.kind, site)


def ring_hop_tap(payload: torch.Tensor, hop: int, *, site: str) -> torch.Tensor:
    """Corruption point in a ring's hop loop: zero the payload arriving at
    hop ``arg`` (1-based, the collectives' hop numbering). The hops are a
    host loop, so the hop is a plain comparison: a fault is taken (and
    noted) at the hop it names, and a ring with fewer hops never takes
    it."""
    plan = active_plan()
    if plan is None:
        return payload
    f = plan.take(HOP_KINDS, site, arg=int(hop))
    if f is None:
        return payload
    plan.note(f.kind, site)
    return torch.zeros_like(payload)


# ---------------------------------------------------------------------------
# Corruption of a CompressedMap (the serve handoff)
# ---------------------------------------------------------------------------

def corrupt_map(cm: Any, kind: str, *, arg: int = 0) -> Any:
    """A corrupted copy of a ``CompressedMap``, cloned on the map's
    device. Same kinds and positions as :func:`stream_tap`; the checksum
    is carried over unchanged (corrupting the stream must break the
    match, not re-sign it). ``value`` adds 1.0 in float32 and rounds to
    the payload's dtype, as the reference does on the host."""
    from ..compress.stream import pack_bitmap, unpack_bitmap
    n_live = int(cm.n_live)
    if kind == "bitflip":
        bitmap = unpack_bitmap(cm.index, cm.m // cm.bs, cm.k // cm.bc)
        flat = bitmap.reshape(-1)
        pos = int(arg) % flat.numel()
        flat[pos] = 1 - flat[pos]
        return dataclasses.replace(cm, index=pack_bitmap(bitmap))
    if kind == "count":
        return dataclasses.replace(cm, n_live=torch.tensor(
            n_live + 1, dtype=torch.int32, device=cm.n_live.device))
    payload = cm.payload.clone()
    if kind == "truncate":
        if n_live > 0:
            payload[n_live - 1] = 0
        return dataclasses.replace(cm, payload=payload)
    if kind in ("nan", "value"):
        if n_live > 0:
            slot = min(int(arg), n_live - 1)
            val = (float("nan") if kind == "nan"
                   else payload[slot, 0, 0].float() + 1.0)
            payload[slot, 0, 0] = val
        return dataclasses.replace(cm, payload=payload)
    raise ValueError(f"unknown map fault kind {kind!r}")


# ---------------------------------------------------------------------------
# Checkpoint and step-level faults
# ---------------------------------------------------------------------------

def corrupt_file(path: str, *, offset: int | None = None) -> None:
    """Flip one byte of a file in place (checkpoint-corruption chaos).
    Default offset: the middle of the file, past any header, inside the
    array data."""
    with open(path, "r+b") as f:
        f.seek(0, 2)
        size = f.tell()
        if size == 0:
            return
        pos = size // 2 if offset is None else int(offset) % size
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))


def crash_tap(tick: int, *, site: str = ENGINE_TICK_SITE) -> None:
    """Kill point in the serving engine's tick loop: raises
    ``TransientStep`` when the armed plan carries a
    ``Fault("crash", site="engine_tick", arg=<tick>)`` for exactly this
    tick. The supervised engine classifies it, restores its last snapshot
    and re-admits the in-flight lanes from their paged KV."""
    plan = active_plan()
    if plan is None:
        return
    f = plan.take(CRASH_KINDS, site, arg=int(tick))
    if f is None:
        return
    plan.note(f.kind, site)
    raise TransientStep(f"injected engine crash at {site} tick {int(tick)}")


def crashing_step(step_fn: Callable, crash_at: int,
                  exc: Callable[[], BaseException] | None = None,
                  times: int = 1) -> Callable:
    """Wrap a step function to raise at its ``crash_at``-th call (1-based),
    ``times`` times in all. Default exception: ``TransientStep``, the
    supervisor's restore-and-retry policy. ``wrapped.calls`` counts the
    calls and the raises."""
    make = exc or (lambda: TransientStep(f"injected crash at call {crash_at}"))
    calls = {"n": 0, "raised": 0}

    def wrapped(*a, **kw):
        calls["n"] += 1
        if calls["n"] >= crash_at and calls["raised"] < times:
            calls["raised"] += 1
            raise make()
        return step_fn(*a, **kw)

    wrapped.calls = calls  # type: ignore[attr-defined]
    return wrapped
