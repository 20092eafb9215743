"""Failure taxonomy and per-class recovery policies (``repro.ft.faults``).

Every ingest boundary routes a failure through one classification, so
"what went wrong" and "what to do about it" are decided in one place:

=====================  =================================================
class                  policy (``policy_for``)
=====================  =================================================
``CorruptStream``      ``recompute-dense``: the (bitmap, payload) stream
                       failed the wire contract (``compress.integrity``);
                       recompute the map from its dense source (serve
                       replaces the leaf with the dense cache, the engine
                       re-runs the masking pass on the map in hand).
``TransientStep``      ``restore-retry``: a step failed for a reason a
                       restore and retry plausibly clears (a preempted
                       device, the card out of memory).
``PoisonBatch``        ``skip-batch``: one batch gave non-finite loss or
                       gradients; restoring would replay it.
``DeviceLoss``         ``remesh``: the device topology changed.
``DeadlineExceeded``   ``shed``: a request blew its deadline.
``Overload``           ``shed``: the bounded pending queue overflowed.
=====================  =================================================

Everything else (``KeyboardInterrupt``, ``SystemExit``, assertion and
programming errors) is not a fault: :func:`classify` returns ``None`` and
the caller re-raises. The card's out-of-memory error
(``torch.cuda.OutOfMemoryError``) is the counterpart of XLA's
``RESOURCE_EXHAUSTED`` and classifies the same way, as ``TransientStep``.
"""
from __future__ import annotations

import torch


class FaultError(RuntimeError):
    """Base of the classified failure taxonomy."""


class CorruptStream(FaultError):
    """A (bitmap, payload) stream failed the wire contract on ingest."""


class TransientStep(FaultError):
    """A step failure that restore + retry plausibly clears."""


class PoisonBatch(FaultError):
    """One batch produced non-finite loss/grads — skip it, keep state."""


class DeviceLoss(FaultError):
    """The device topology changed under the job."""


class DeadlineExceeded(FaultError):
    """A request blew its deadline (TTL in engine ticks) — shed it."""


class Overload(FaultError):
    """The bounded pending queue overflowed — shed the newest arrivals."""


POLICIES: dict[type, str] = {
    CorruptStream: "recompute-dense",
    TransientStep: "restore-retry",
    PoisonBatch: "skip-batch",
    DeviceLoss: "remesh",
    DeadlineExceeded: "shed",
    Overload: "shed",
}

# policies that are normal-operation outcomes, not system failures
SHED_POLICIES = ("shed",)

# Exception text markers of a known transient infrastructure failure whose
# raiser did not use the taxonomy. Deliberately narrow: an unrecognised
# error is a bug and must surface, not retry.
_TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "UNAVAILABLE", "DEADLINE_EXCEEDED",
                      "ABORTED", "INTERNAL", "preempt", "socket closed",
                      "connection reset")
_POISON_MARKERS = ("nan", "non-finite", "not finite", "inf loss")
_CLASSES = (CorruptStream, TransientStep, PoisonBatch, DeviceLoss,
            DeadlineExceeded, Overload)


def classify(exc: BaseException) -> type[FaultError] | None:
    """Map an exception onto its fault class, or ``None`` for "not a
    fault — re-raise". Taxonomy instances win; the card running out of
    memory is transient; other errors match by status marker."""
    if isinstance(exc, FaultError):
        for cls in _CLASSES:
            if isinstance(exc, cls):
                return cls
        return TransientStep
    if not isinstance(exc, Exception):
        return None                      # KeyboardInterrupt / SystemExit
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return TransientStep
    low = f"{type(exc).__name__}: {exc}".lower()
    if isinstance(exc, FloatingPointError) or any(m in low for m in _POISON_MARKERS):
        return PoisonBatch
    if isinstance(exc, (RuntimeError, OSError, ConnectionError)) and \
            any(m.lower() in low for m in _TRANSIENT_MARKERS):
        return TransientStep
    return None


def policy_for(exc: BaseException) -> str | None:
    """The recovery policy name for an exception, or ``None`` (re-raise)."""
    cls = classify(exc)
    return POLICIES[cls] if cls is not None else None
