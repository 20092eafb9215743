"""Request admission, preemption and retirement for the serving engine
(``repro.serve.scheduler``, host-side Python line for line).

Everything here is host-side policy over plain Python state: the
scheduler never touches device tensors. The engine asks it three
questions per step: who newly fits in a free slot (FCFS over arrived
requests), who must be preempted (round-robin fairness under slot
pressure: a lane that has held its slot ``preempt_after`` consecutive
steps while others wait is evicted to the compressed pool and requeued),
and who is done (EOS or ``max_new`` reached).

Terminal statuses:

``done``      finished normally (EOS or ``max_new``).
``rejected``  can never run on this engine: the prompt+gen total is
              beyond the cache ladder. A permanent verdict at admission.
``shed``      could have run, but an SLO dropped it: ``shed_reason`` is
              ``"deadline"`` (TTL unmeetable given the slot clock, at
              admission or mid-flight), ``"overload"`` (bounded pending
              queue overflowed, newest fresh arrivals first), or
              ``"retry-budget"`` (crash re-admissions exhausted
              ``retry_budget``).

A transiently infeasible ``fits`` verdict (``"later"``) is not terminal:
the request stays queued at its FCFS position and is re-tried every tick,
bounded by the shed policy above. Requests that finish after surviving an
engine crash also carry ``recovered=True``.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


@dataclasses.dataclass
class Request:
    """One serving request plus its host-side decode bookkeeping.

    ``pos`` is the cache position the next step writes; ``fed`` counts
    prompt tokens whose KV is final in the cache. Until ``pos`` reaches
    ``prompt_len`` the lane is teacher-forced (chunked-prefill tail: the
    next input token comes from the prompt and the step's output is
    discarded); from there on the model's own tokens feed back."""
    rid: int
    prompt: np.ndarray              # (P,) int32
    max_new: int
    arrival: int = 0                # engine tick at which it becomes visible
    eos_token: int | None = None
    deadline_ticks: int | None = None  # TTL in engine ticks from arrival
    retry_budget: int = 3           # crash re-admissions before shedding
    # --- runtime ---
    out: list = dataclasses.field(default_factory=list)
    next_tok: int = 0
    pos: int = 0
    fed: int = 0                    # prompt tokens with final KV in cache
    status: str = "waiting"         # waiting | running | done | rejected | shed
    shed_reason: str = ""           # deadline | overload | retry-budget
    slot_steps: int = 0             # consecutive steps in-slot (preempt clock)
    evictions: int = 0
    retries: int = 0                # crash re-admissions consumed
    recovered: bool = False         # survived an engine crash in-flight
    deadline: int | None = None     # absolute tick, fixed at creation —
                                    # preemption mutates `arrival`, so the
                                    # TTL anchors to the ORIGINAL arrival
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    token_times: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.deadline is None and self.deadline_ticks is not None:
            self.deadline = self.arrival + int(self.deadline_ticks)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_len(self) -> int:
        """Cache positions the request needs end to end."""
        return self.prompt_len + self.max_new

    @property
    def done(self) -> bool:
        if len(self.out) >= self.max_new:
            return True
        return (self.eos_token is not None and len(self.out) > 0
                and self.out[-1] == self.eos_token)


def synthetic_trace(n_requests: int, *, vocab: int, seed: int = 0,
                    prompt_lo: int = 8, prompt_hi: int = 48,
                    gen_lo: int = 8, gen_hi: int = 32,
                    arrival_every: int = 0,
                    deadline_ticks: int | None = None) -> list[Request]:
    """Deterministic heavy-traffic trace: ``n_requests`` requests with
    varying prompt/gen lengths. ``arrival_every`` staggers arrivals every
    N engine steps (0 = all arrive at tick 0 — a burst);
    ``deadline_ticks`` attaches a uniform TTL to every request."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        plen = int(rng.integers(prompt_lo, prompt_hi + 1))
        gen = int(rng.integers(gen_lo, gen_hi + 1))
        prompt = rng.integers(1, vocab, size=plen).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new=gen,
                            arrival=i * arrival_every,
                            deadline_ticks=deadline_ticks))
    return reqs


# per-request runtime fields captured by Scheduler.snapshot() — list
# fields (out, token_times) are copied separately
_REQ_FIELDS = ("next_tok", "pos", "fed", "status", "shed_reason",
               "slot_steps", "evictions", "retries", "recovered",
               "arrival", "t_submit", "t_first", "t_done")


class Scheduler:
    """FCFS admission with optional round-robin preemption, a bounded
    pending queue (``queue_bound`` — overflow is shed, newest fresh
    arrivals first) and deadline-aware admission (a request whose TTL
    can't be met given the engine's slot clock is shed, not queued)."""

    def __init__(self, requests: list[Request], *, preempt_after: int = 0,
                 queue_bound: int = 0):
        self.waiting: deque[Request] = deque(
            sorted(requests, key=lambda r: (r.arrival, r.rid)))
        self.preempt_after = preempt_after
        self.queue_bound = queue_bound     # 0 = unbounded
        self.evictions = 0
        self.n_shed = 0
        self.deadline_misses = 0           # sheds with reason "deadline"
        self.deferrals = 0                 # transient fits-veto re-queues
        self.completed: list[Request] = []
        self._all: dict = {r.rid: r for r in requests}

    # ------------------------------------------------------------------
    def pending(self) -> int:
        return len(self.waiting)

    def next_arrival(self) -> int | None:
        return self.waiting[0].arrival if self.waiting else None

    def shed(self, r: Request, reason: str) -> None:
        """Terminal drop under an SLO: distinct from ``rejected`` (which
        means the request could never run on this engine at all)."""
        r.status = "shed"
        r.shed_reason = reason
        self.n_shed += 1
        if reason == "deadline":
            self.deadline_misses += 1
        self.completed.append(r)

    def shed_overflow(self, tick: int) -> list[Request]:
        """Bounded pending queue: when more than ``queue_bound`` *fresh*
        arrivals are waiting, shed the newest of them. The bound is
        admission backpressure, so it counts (and sheds) only requests
        with no progress — preempted or crash-requeued work-in-progress
        holds paged KV and real tokens, and must neither be shed nor
        squeeze fresh arrivals out of the queue by occupying it."""
        if self.queue_bound <= 0:
            return []
        fresh = [r for r in self.waiting if r.arrival <= tick
                 and r.pos == 0 and r.evictions == 0 and r.retries == 0]
        excess = len(fresh) - self.queue_bound
        if excess <= 0:
            return []
        victims = sorted(fresh, key=lambda r: (r.arrival, r.rid))[-excess:]
        for r in victims:
            self.waiting.remove(r)
            self.shed(r, "overload")
        return victims

    def admit(self, tick: int, free_slots: int,
              fits=lambda r: True, eta=None) -> list[Request]:
        """Pop up to ``free_slots`` arrived requests, FCFS.

        ``fits`` returns a verdict per request: ``"ok"`` (admit),
        ``"never"`` (beyond the cache ladder: terminal ``rejected``) or
        ``"later"`` (transiently infeasible,
        e.g. the hot-set budget is full of other lanes — the request
        keeps its FCFS position and is re-tried next tick). Plain
        ``True``/``False`` still work and mean ok/never.

        ``eta(r)`` is the engine's minimum ticks-to-finish estimate; a
        request whose deadline can't be met even if admitted right now
        (``tick + eta > deadline``) is shed instead of occupying a slot
        it cannot use to meet its SLO."""
        admitted: list[Request] = []
        deferred: list[Request] = []
        while self.waiting and free_slots > 0 \
                and self.waiting[0].arrival <= tick:
            r = self.waiting.popleft()
            if r.deadline is not None:
                need = eta(r) if eta is not None \
                    else max(r.total_len - 1 - r.pos, 0)
                if tick + need > r.deadline:
                    self.shed(r, "deadline")
                    continue
            verdict = fits(r)
            if verdict is True:
                verdict = "ok"
            elif verdict is False:
                verdict = "never"
            if verdict == "never":
                r.status = "rejected"
                self.completed.append(r)
                continue
            if verdict == "later":
                self.deferrals += 1
                deferred.append(r)
                continue
            r.status = "running"
            r.slot_steps = 0
            admitted.append(r)
            free_slots -= 1
        for r in reversed(deferred):       # restore FCFS queue position
            self.waiting.appendleft(r)
        return admitted

    def should_preempt(self, r: Request) -> bool:
        """Evict a lane that has monopolized its slot while others wait."""
        return (self.preempt_after > 0 and r.slot_steps >= self.preempt_after
                and bool(self.waiting))

    def preempt(self, r: Request, tick: int) -> None:
        r.status = "waiting"
        r.slot_steps = 0
        r.evictions += 1
        r.arrival = tick                # back of the arrived queue
        self.evictions += 1
        self.waiting.append(r)

    def retire(self, r: Request) -> None:
        r.status = "done"
        self.completed.append(r)

    def requeue_front(self, r: Request) -> None:
        """Crash re-admission: a formerly-running lane goes back to the
        FRONT of the queue (it already holds paged KV and progress) —
        unlike ``preempt``, its arrival and TTL anchor are untouched."""
        r.status = "waiting"
        r.slot_steps = 0
        self.waiting.appendleft(r)

    # ------------------------------------------------------------------
    # crash-recovery snapshots (host-side bookkeeping only — the KV
    # itself is snapshotted by the engine paging lanes into the pool)
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        reqs = {}
        for r in self._all.values():
            d = {f: getattr(r, f) for f in _REQ_FIELDS}
            d["out"] = list(r.out)
            d["token_times"] = list(r.token_times)
            reqs[r.rid] = d
        return {"reqs": reqs,
                "waiting": [r.rid for r in self.waiting],
                "completed": [r.rid for r in self.completed],
                "evictions": self.evictions, "n_shed": self.n_shed,
                "deadline_misses": self.deadline_misses,
                "deferrals": self.deferrals}

    def restore(self, snap: dict) -> None:
        for rid, d in snap["reqs"].items():
            r = self._all[rid]
            for f in _REQ_FIELDS:
                setattr(r, f, d[f])
            r.out = list(d["out"])
            r.token_times = list(d["token_times"])
        self.waiting = deque(self._all[rid] for rid in snap["waiting"])
        self.completed = [self._all[rid] for rid in snap["completed"]]
        self.evictions = snap["evictions"]
        self.n_shed = snap["n_shed"]
        self.deadline_misses = snap["deadline_misses"]
        self.deferrals = snap["deferrals"]
