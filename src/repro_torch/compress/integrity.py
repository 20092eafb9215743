"""Stream integrity (``repro.compress.integrity``): the validated wire
contract of the (bitmap, payload) stream, at three
``ZebraConfig.validation`` levels:

``off``
    No check and no checksum: the hot path is the unvalidated code.
``structural``
    Invariants computable from the stream alone: ``n_live ==
    popcount(bitmap)`` (one flipped bitmap bit moves the popcount by 1);
    the payload's capacity is the block count; every live slot is finite
    (NaN/Inf poison); every live slot has a nonzero element (a kept block
    always has one, so an all-zero live slot means a truncated payload or
    a shifted slot map).
``checksum``
    Structural plus a uint32 position-mixed XOR fold over the bitmap
    bits, the live payload words and ``n_live`` (:func:`stream_checksum`),
    sealed by the producer, carried in ``CompressedMap.checksum``, and
    recomputed and compared on ingest: it sees a live value changed to
    another finite nonzero value, which no structural invariant can.

Two surfaces for the two kinds of boundary:

* :func:`check_stream` gives a bool tensor on the stream's device, "the
  stream is intact"; the engine reads it on the host and recovers from
  the dense map on a failure, calling :func:`note_failure` so a chaos run
  can count detections (:func:`failures`).
* :func:`validate_map` / :func:`validate_payload` raise
  ``ft.faults.CorruptStream`` naming the first failed invariant, for
  boundaries where the stream is handed over whole (serve's prefill ->
  decode handoff). They run the checks as torch ops on the stream's
  device and read back only the scalars that decide the verdict.

Checksums are held as int64 tensors in ``[0, 2**32)``: the card's
``torch.uint32`` lacks most arithmetic, so the fold runs in int64 masked
to 32 bits, each product by a 32-bit constant split so that none passes
2**63.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

VALIDATION_LEVELS = ("off", "structural", "checksum")

# Knuth multiplicative-hash constants (odd, so bijective mod 2**32): the
# position mix makes the XOR fold order-sensitive, so two swapped words or
# two identical flips at different positions still change the fold
_K1 = 2654435761
_K2 = 40503 * 65537 + 1
_MASK = 0xFFFFFFFF


def validate_level(level: str) -> str:
    if level not in VALIDATION_LEVELS:
        raise ValueError(f"unknown validation level {level!r}; expected one "
                         f"of {VALIDATION_LEVELS}")
    return level


# ---------------------------------------------------------------------------
# uint32 folds, in int64
# ---------------------------------------------------------------------------

def _mul32_(a: torch.Tensor, k: int, bound: int) -> torch.Tensor:
    """``a = (a * k) mod 2**32`` in place, for int64 ``a`` in ``[0,
    bound]``. Where ``bound * k`` could pass 2**63, ``k`` is split into
    16-bit halves, so no product passes 2**48."""
    if bound * k < 2 ** 63:
        return a.mul_(k).bitwise_and_(_MASK)
    hi = (a * (k >> 16)).bitwise_and_(0xFFFF).bitwise_left_shift_(16)
    return a.mul_(k & 0xFFFF).add_(hi).bitwise_and_(_MASK)


def _xor_fold(a: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis: halves folded onto each other over a
    length padded with zeros (XOR's identity) to a power of two."""
    n = a.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        a = torch.nn.functional.pad(a, (0, p - n))
    while a.shape[-1] > 1:
        h = a.shape[-1] // 2
        a = a[..., :h] ^ a[..., h:]
    return a[..., 0]


def _payload_words(payload: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(nb, bs, bc) payload -> ((nb, words) int64 bit patterns, the words'
    bit width): float32 as its 32-bit words, bfloat16 and float16 as their
    16-bit words, integers by value mod 2**32."""
    flat = payload.reshape(payload.shape[0], -1)
    if flat.dtype == torch.float32:
        return flat.view(torch.int32).to(torch.int64).bitwise_and_(_MASK), 32
    if flat.dtype in (torch.bfloat16, torch.float16):
        return flat.view(torch.int16).to(torch.int64).bitwise_and_(0xFFFF), 16
    if flat.is_floating_point():
        raise TypeError(f"stream checksum: no word layout for {flat.dtype}")
    return flat.to(torch.int64).bitwise_and_(_MASK), 32


def _slot_hashes(payload: torch.Tensor) -> torch.Tensor:
    """Per-slot position-mixed XOR fold -> (nb,) int64 in [0, 2**32)."""
    words, width = _payload_words(payload)
    n = words.shape[1]
    words += torch.arange(n, dtype=torch.int64, device=words.device)
    bound = (1 << width) - 1 + max(n - 1, 0)
    if bound > _MASK:
        words.bitwise_and_(_MASK)
        bound = _MASK
    return _xor_fold(_mul32_(words, _K1, bound))


def stream_checksum(payload: torch.Tensor, bitmap: torch.Tensor,
                    n_live: torch.Tensor) -> torch.Tensor:
    """The uint32 checksum of one stream, as a () int64 tensor on the
    payload's device: bitmap bits, live payload slots and the live count,
    each position-mixed before the XOR fold. Slots at or past ``n_live``
    are left out, so a producer that leaves garbage in the tail and one
    that zeroes it hash alike."""
    dev = payload.device
    nb = payload.shape[0]
    nl = torch.as_tensor(n_live, device=dev).to(torch.int64).bitwise_and(_MASK)
    bits = bitmap.reshape(-1).to(torch.int64).bitwise_and_(_MASK)
    bits += torch.arange(bits.numel(), dtype=torch.int64, device=dev)
    bits.bitwise_and_(_MASK)
    bm_hash = _xor_fold(_mul32_(bits, _K1, _MASK))
    s = torch.arange(nb, dtype=torch.int64, device=dev)
    mixed = _mul32_((_slot_hashes(payload) + s).bitwise_and_(_MASK), _K2, _MASK)
    pl_hash = _xor_fold(torch.where(s < nl, mixed, torch.zeros_like(mixed)))
    return (_mul32_(bm_hash, _K2, _MASK) ^ pl_hash
            ^ _mul32_(nl.clone(), _K1, _MASK))


# ---------------------------------------------------------------------------
# The checks, on the stream's device
# ---------------------------------------------------------------------------

def _static_contract(payload: torch.Tensor, bitmap: torch.Tensor) -> None:
    """A wrong capacity is a programming error, not data corruption."""
    nb = bitmap.numel()
    if payload.dim() != 3 or payload.shape[0] != nb:
        raise ValueError(
            f"stream contract: payload {tuple(payload.shape)} != worst-case "
            f"capacity ({nb}, bs, bc) for bitmap {tuple(bitmap.shape)}")


def _bad_live_slots(payload: torch.Tensor, n_live: torch.Tensor,
                    live_nonzero: bool) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """(nb,) bool masks of the live slots that hold a non-finite value
    (None for an integer payload) and of those that are all zero (None
    unless ``live_nonzero``)."""
    nb = payload.shape[0]
    flat = payload.reshape(nb, -1)
    live = torch.arange(nb, device=payload.device) < n_live
    nonfinite = (live & ~torch.isfinite(flat).all(dim=1)
                 if flat.is_floating_point() else None)
    # NaN != 0, so a NaN slot is not all zero, as max|x| == 0 has it
    zeroed = live & ~(flat != 0).any(dim=1) if live_nonzero else None
    return nonfinite, zeroed


def check_stream(payload: torch.Tensor, bitmap: torch.Tensor, n_live: torch.Tensor, *,
                 level: str, checksum: torch.Tensor | None = None,
                 live_nonzero: bool = True) -> torch.Tensor:
    """() bool tensor on the payload's device: does this stream satisfy
    the wire contract at ``level``? At ``off`` it checks nothing.

    ``live_nonzero`` asserts the kept-block invariant (every live slot
    has a nonzero element); turn it off where the bitmap may keep
    all-zero blocks (``t_obj == 0``)."""
    validate_level(level)
    if level == "off":
        return torch.ones((), dtype=torch.bool, device=payload.device)
    _static_contract(payload, bitmap)
    nb = payload.shape[0]
    nl = torch.as_tensor(n_live, device=payload.device).to(torch.int64)
    pop = bitmap.to(torch.int64).sum()
    ok = (nl == pop) & (nl >= 0) & (nl <= nb)
    for bad in _bad_live_slots(payload, nl, live_nonzero):
        if bad is not None:
            ok = ok & ~bad.any()
    if level == "checksum" and checksum is not None:
        ok = ok & (stream_checksum(payload, bitmap, nl)
                   == torch.as_tensor(checksum, device=payload.device)
                   .to(torch.int64).bitwise_and(_MASK))
    return ok


# ---------------------------------------------------------------------------
# Detections (host list)
# ---------------------------------------------------------------------------

_FAILURES: list[str] = []


def note_failure(site: str) -> None:
    """Record one detected-and-recovered stream failure; the recovery
    branch calls it. Chaos runs read :func:`failures` to assert that the
    detection fired (a bitwise-equal output alone cannot tell "detected
    and recovered" from "the fault never bit")."""
    _FAILURES.append(str(site))


def failures() -> list[str]:
    return list(_FAILURES)


def clear_failures() -> None:
    _FAILURES.clear()


# ---------------------------------------------------------------------------
# Validation of a stream handed over whole
# ---------------------------------------------------------------------------

def _first(mask: torch.Tensor | None, device) -> torch.Tensor:
    """Index of the first True of ``mask`` as a () int64 tensor, -1 if
    none (or no mask)."""
    if mask is None or mask.numel() == 0:
        return torch.full((), -1, dtype=torch.int64, device=device)
    return torch.where(mask.any(), mask.to(torch.int32).argmax(),
                       torch.full((), -1, dtype=torch.int64, device=device))


def validate_payload(payload: torch.Tensor, bitmap: torch.Tensor, n_live, *, level: str,
                     checksum=None, live_nonzero: bool = True,
                     site: str = "stream") -> None:
    """Validate one stream; raise ``ft.faults.CorruptStream`` naming the
    first failed invariant, in the checks' order of :func:`check_stream`.
    The checks run on the payload's device; one host read brings back
    ``n_live``, the popcount, the first bad slots and the checksum."""
    from ..ft.faults import CorruptStream
    validate_level(level)
    if level == "off":
        return
    nb = bitmap.numel()
    if payload.dim() != 3:
        raise CorruptStream(f"{site}: payload shape {tuple(payload.shape)} is not "
                            f"a (n_blocks, bs, bc) buffer")
    if payload.shape[0] != nb:
        raise CorruptStream(f"{site}: payload capacity {payload.shape[0]} != "
                            f"block count {nb}")
    dev = payload.device
    nl_t = torch.as_tensor(n_live, device=dev).to(torch.int64)
    nonfinite, zeroed = _bad_live_slots(payload, nl_t, live_nonzero)
    got = (stream_checksum(payload, bitmap, nl_t)
           if level == "checksum" and checksum is not None
           else torch.full((), -1, dtype=torch.int64, device=dev))
    nl, pop, bad, zero, got = torch.stack([
        nl_t, bitmap.to(torch.int64).sum(), _first(nonfinite, dev), _first(zeroed, dev),
        got]).tolist()
    if not (0 <= nl <= nb):
        raise CorruptStream(f"{site}: n_live {nl} outside [0, {nb}]")
    if nl != pop:
        raise CorruptStream(f"{site}: n_live {nl} != popcount(bitmap) {pop} "
                            f"— a flipped index bit relocates every later "
                            f"payload block")
    if bad >= 0:
        raise CorruptStream(f"{site}: non-finite payload in live slot {bad}")
    if zero >= 0:
        raise CorruptStream(f"{site}: live payload slot {zero} is all-zero — "
                            f"truncated payload or shifted slot map")
    if level == "checksum":
        if checksum is None:
            raise CorruptStream(f"{site}: validation level 'checksum' but "
                                f"the stream carries no checksum")
        want = int(checksum) & _MASK
        if got != want:
            raise CorruptStream(f"{site}: checksum mismatch (stored "
                                f"{want:#010x}, recomputed {got:#010x})")


def validate_map(cm: Any, *, level: str, live_nonzero: bool = True,
                 site: str = "stream") -> None:
    """Validate one ``CompressedMap`` (raises ``CorruptStream``); the
    packed index is unpacked to the (nm, nk) bitmap the contract folds."""
    from .stream import unpack_bitmap       # stream imports this module
    validate_level(level)
    if level == "off":
        return
    bitmap = unpack_bitmap(cm.index, cm.m // cm.bs, cm.k // cm.bc)
    validate_payload(cm.payload, bitmap, cm.n_live, level=level,
                     checksum=cm.checksum, live_nonzero=live_nonzero, site=site)


def map_checksum(cm: Any) -> torch.Tensor:
    """The stream checksum of one ``CompressedMap`` (over the unpacked
    bitmap, the live payload and n_live)."""
    from .stream import unpack_bitmap
    bitmap = unpack_bitmap(cm.index, cm.m // cm.bs, cm.k // cm.bc)
    return stream_checksum(cm.payload, bitmap, cm.n_live)


def attach_checksum(cm: Any) -> Any:
    """The map with its checksum computed and carried in-band."""
    return dataclasses.replace(cm, checksum=map_checksum(cm))
