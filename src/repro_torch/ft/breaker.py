"""Per-boundary circuit breaker over the compressed-stream ingest paths
(``repro.ft.breaker``; stdlib only).

Every ingest boundary recovers per item: a corrupt handoff leaf degrades
to its dense source and everything else stays compressed. That is right
for a blip, but a persistently sick boundary (a flaky link) would re-pay
compress, validate and fallback on every item forever. The breaker is the
aggregate policy on top: after ``trip_after`` ``CorruptStream``
detections inside a sliding ``window`` of ticks at one site, the whole
site trips to its dense path wholesale (no compression, no per-item
validation), then probes the compressed path again on an exponential
backoff and closes once ``close_after`` consecutive probes pass.

State machine (per site)::

    closed ──(trip_after failures in window)──▶ open
    open ──(next_probe reached; one item allowed)──▶ half_open
    half_open ──(probe fails)──▶ open   (probe interval *= probe_backoff)
    half_open ──(close_after consecutive passes)──▶ closed

The clock is the caller's tick counter (call counts), not wall time, so
chaos runs stay deterministic. A boundary with no owner of a board in
scope (``launch.serve.validate_state_ingest``) consults the ambient board
armed with :func:`breaker_scope`, on ``ft.inject``'s contextvar idiom.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from collections import deque
from typing import Iterator

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


@dataclasses.dataclass
class BreakerConfig:
    trip_after: int = 3        # failures inside `window` ticks that trip
    window: int = 16           # sliding detection window, in ticks
    probe_after: int = 4       # ticks from trip to the first half-open probe
    probe_backoff: float = 2.0 # failed probe multiplies the next wait ...
    probe_cap: int = 64        # ... up to this many ticks between probes
    close_after: int = 2       # consecutive probe passes that close


class CircuitBreaker:
    """One boundary's breaker. All methods take the caller's ``now``
    tick; the breaker never reads a clock of its own."""

    def __init__(self, site: str, cfg: BreakerConfig | None = None):
        self.site = site
        self.cfg = cfg or BreakerConfig()
        self.state = CLOSED
        self._fail_ticks: deque[int] = deque()
        self._probe_wait = float(self.cfg.probe_after)
        self._next_probe = 0
        self._passes = 0           # consecutive half-open probe passes
        # counters (monotone; surfaced in snapshot()/label())
        self.trips = 0             # closed -> open transitions
        self.probes = 0            # half-open items with a recorded verdict
        self.probe_passes = 0
        self.probe_fails = 0
        self.skipped = 0           # items sent dense while open
        self.failures_seen = 0     # every recorded failure, any state

    # ------------------------------------------------------------------
    def allow(self, now: int) -> bool:
        """May this item take the compressed path at tick ``now``?
        ``False`` = the site is open: take the dense path wholesale,
        skipping per-item validate + fallback. The first item at or past
        the probe deadline is the half-open probe and IS allowed."""
        if self.state == OPEN:
            if now >= self._next_probe:
                self.state = HALF_OPEN
                return True
            self.skipped += 1
            return False
        return True                # closed or half_open (probing)

    def record_success(self, now: int) -> None:
        if self.state == HALF_OPEN:
            self.probes += 1
            self.probe_passes += 1
            self._passes += 1
            if self._passes >= self.cfg.close_after:
                self.state = CLOSED
                self._fail_ticks.clear()
                self._probe_wait = float(self.cfg.probe_after)
        # closed: nothing to do — old failures age out by tick, below

    def record_failure(self, now: int) -> None:
        self.failures_seen += 1
        if self.state == HALF_OPEN:
            # failed probe: back to open on the decayed schedule
            self.probes += 1
            self.probe_fails += 1
            self._passes = 0
            self._probe_wait = min(self._probe_wait * self.cfg.probe_backoff,
                                   float(self.cfg.probe_cap))
            self._next_probe = now + int(self._probe_wait)
            self.state = OPEN
            return
        if self.state == OPEN:     # racing items in the same tick
            return
        self._fail_ticks.append(now)
        while self._fail_ticks and now - self._fail_ticks[0] > self.cfg.window:
            self._fail_ticks.popleft()
        if len(self._fail_ticks) >= self.cfg.trip_after:
            self.state = OPEN
            self.trips += 1
            self._passes = 0
            self._probe_wait = float(self.cfg.probe_after)
            self._next_probe = now + int(self._probe_wait)
            self._fail_ticks.clear()

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        return {"site": self.site, "state": self.state, "trips": self.trips,
                "probes": self.probes, "probe_passes": self.probe_passes,
                "probe_fails": self.probe_fails, "skipped": self.skipped,
                "failures_seen": self.failures_seen}

    def label(self) -> str:
        """SiteAux-style compact label, e.g. ``page:open(trips=1,probes=2)``."""
        return (f"{self.site}:{self.state}(trips={self.trips},"
                f"probes={self.probes},skipped={self.skipped})")


class BreakerBoard:
    """Per-site breakers behind one shared tick clock.

    The owner advances the clock (``advance(tick)`` by an owner with a clock of
    its own, ``tick()`` at call-counted boundaries); every consult then reads
    ``now``. Sites materialize lazily on first consult, so wiring a
    board in is free for boundaries that never fail."""

    def __init__(self, cfg: BreakerConfig | None = None):
        self.cfg = cfg or BreakerConfig()
        self.now = 0
        self.breakers: dict[str, CircuitBreaker] = {}

    def get(self, site: str) -> CircuitBreaker:
        br = self.breakers.get(site)
        if br is None:
            br = self.breakers[site] = CircuitBreaker(site, self.cfg)
        return br

    # -- clock ----------------------------------------------------------
    def advance(self, now: int) -> None:
        self.now = max(self.now, int(now))

    def tick(self) -> None:
        self.now += 1

    # -- consults -------------------------------------------------------
    def allow(self, site: str) -> bool:
        return self.get(site).allow(self.now)

    def record_success(self, site: str) -> None:
        self.get(site).record_success(self.now)

    def record_failure(self, site: str) -> None:
        self.get(site).record_failure(self.now)

    # -- reporting ------------------------------------------------------
    def snapshot(self) -> dict[str, dict]:
        return {s: b.snapshot() for s, b in sorted(self.breakers.items())}

    def labels(self) -> list[str]:
        return [b.label() for _, b in sorted(self.breakers.items())]

    def tripped_sites(self) -> list[str]:
        return sorted(s for s, b in self.breakers.items() if b.trips > 0)

    @property
    def trips(self) -> int:
        return sum(b.trips for b in self.breakers.values())

    @property
    def probes(self) -> int:
        return sum(b.probes for b in self.breakers.values())


_ACTIVE_BOARD: contextvars.ContextVar[BreakerBoard | None] = \
    contextvars.ContextVar("repro_torch_breaker_board", default=None)


def active_board() -> BreakerBoard | None:
    return _ACTIVE_BOARD.get()


@contextlib.contextmanager
def breaker_scope(board: BreakerBoard) -> Iterator[BreakerBoard]:
    """Arm a board for boundaries that have no owner of one in scope
    (``launch.serve.validate_state_ingest``)."""
    tok = _ACTIVE_BOARD.set(board)
    try:
        yield board
    finally:
        _ACTIVE_BOARD.reset(tok)
