"""Continuous-batching serving engine over a paged compressed-KV pool
(``repro.serve.engine``).

One engine = one model + one hot working set: a dense batched cache at
bucketed shape ``(Bb, C)`` whose lanes are in-flight requests at
*different* sequence positions, advanced together by the slotted decode
step (``steps.decode_slotted``, a (B,) ``pos``). Everything not in a lane
lives in the :class:`~repro_torch.serve.pool.PagedKVPool` as compressed
payload slabs; admission and eviction are page-in/page-out in stream
form.

Bounded shapes, asserted, not observed
--------------------------------------
Decode may only run at ``(Bb, C)`` pairs from the declared power-of-two
ladders (``batch_ladder`` x ``cache_ladder``) and prefill only at prompt
buckets from ``prefill_ladder``; any other shape raises before it runs.
Cache length only grows (grow-only C keeps page-in padding
one-directional), and local-attention rings stay at ``T == window``
because the cache ladder starts at ``pow2_ceil(window)``, so a page
written at one bucket reads back bitwise at any later bucket.

Chunked admission
-----------------
Prompts are never padded (padding would poison cache positions the decode
mask cannot hide). A request prefills its largest power-of-two prefix
``Pb = pow2_floor(P)`` in one exact-shape call, and the remaining ``P -
Pb`` prompt tokens ride the slotted decode as teacher-forced steps (output
discarded): mixed prefill/decode continuous batching. When ``Pb == P`` the
last prompt token is replayed at ``pos = P - 1`` (rewriting its own KV
with the identical value) to produce the first sampled token; prompts
shorter than the smallest prefill bucket skip prefill and teacher-force
from ``pos 0``.

In-place caches
---------------
The port's decode writes K/V into the hot set in place (the reference's
decode returns new caches and donates the old). So lane surgery copies
where the reference's slices were values: :meth:`_take_lane` clones the
lane, :meth:`_set_lane` writes into the hot tensors, a bucket change
builds the new hot set from copies taken before the old one is dropped,
and a restore rebuilds the hot set from ``init_cache`` and the pool.

Tensor parallelism
------------------
A model cut for a mesh (``sharding.build_sharded``: ``model.mesh``) runs
its prefill and slotted decode under the mesh's hints, as the reference's
engine jits them under its sharding hints; each rank holds its K/V heads
of the hot set (``LM.init_cache``) and pages them to its own pool
(``PagedKVPool(tp=...)``), which meters the whole cache's pages. On a
mesh of D > 1 data ranks the lanes follow the reference's ``batch_spec``:
a hot set of ``Bb`` lanes with ``Bb % D == 0`` is split over ``data`` in
contiguous blocks of ``Bb / D`` (each data rank decodes its block, and
the next tokens are gathered over ``data``), and any other hot set, like
every prefill (batch 1), runs whole on every data rank
(``sharding_hints(whole_batch=True)``: the sites count its rows once and
the MoE routes them once). The bookkeeping and the pool are replicated
over ``data``: every rank makes every pool call on the same tensors (a
lane paged out is broadcast over ``data`` from the rank that holds it,
:meth:`_take_lanes`, one broadcast a holder for a snapshot's or a bucket
change's lanes; a lane paged in is written by its holder alone,
:meth:`_set_lane`), so fault plans, breakers and meters see the same
calls everywhere. Every rank takes the same decision at every tick: the
tokens come from the logits every model rank holds bit for bit, sampling
draws from a generator seeded by (seed, step), and the scheduler reads
ticks and lengths alone (the wall clock only stamps the latency report),
so the ranks admit, evict, retire and restore alike and meet at every
collective.

Resilience
----------
``run(..., ft_cfg=FTConfig(...))`` supervises the tick loop with the
training supervisor's classify/backoff/decay policy
(``ft.supervisor.FailurePolicy``): every ``snapshot_every`` ticks the
engine snapshots (every lane paged out to the pool, plus a copy of the
host bookkeeping), and a classified crash (``ft.inject.crash_tap`` at site
``"engine_tick"``) restores the snapshot and re-admits the in-flight
requests from their paged compressed KV. Generated tokens are kept, not
replayed, and greedy decoding makes the recovered run token-identical to
an uncrashed one. Deadlines (``Request.deadline``) are enforced at
admission (shed what cannot finish in time) and mid-flight (cancel a lane
past its TTL); the pending queue is bounded by ``queue_bound`` with
overload shedding; and a per-site :class:`~repro_torch.ft.breaker.
BreakerBoard` trips a persistently corrupt page-ingest boundary to its
dense path wholesale.
"""
from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from ..ft.breaker import BreakerBoard, BreakerConfig
from ..ft.faults import classify as ft_classify
from ..ft.inject import crash_tap
from ..ft.supervisor import FailurePolicy, FTConfig
from ..launch.steps import decode_slotted, prefill
from ..models.lm import LM
from .bucket import bucket_ladder, pow2_bucket, pow2_ceil, pow2_floor
from .pool import PagedKVPool
from .scheduler import Request, Scheduler


def _tree_map(f, *trees):
    """``f`` over the leaves of nested dicts and lists of the same
    structure (the cache tree); None stays None."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(f, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(f, *xs) for xs in zip(*trees))
    if t is None:
        return None
    return f(*trees)


def check_servable(cfg) -> None:
    """Raise for a config ``ServeEngine`` does not serve: an encoder, a
    layer type that carries recurrent state, or a local window that is
    not a power of two."""
    if cfg.encoder_layers:
        raise NotImplementedError("ServeEngine serves decoder-only "
                                  "stacks (no encoder cross-attention)")
    bad = sorted({t for t in cfg.layer_pattern[:cfg.n_layers]} - {"global", "local"})
    if bad:
        raise NotImplementedError(
            f"ServeEngine pages attention caches only; layer types "
            f"{bad} carry recurrent state")
    if "local" in cfg.layer_pattern[:cfg.n_layers] and (cfg.window & (cfg.window - 1)):
        raise ValueError(f"window {cfg.window} must be a power of two "
                         "so ring slots align across prefill buckets")


class ServeEngine:
    def __init__(self, model: LM, *, n_slots: int = 4, max_cache_len: int = 256,
                 page_tokens: int = 16, min_prefill: int = 8, validation: str = "off",
                 temperature: float = 0.0, seed: int = 0, queue_bound: int = 0,
                 max_hot_positions: int = 0, breaker: BreakerConfig | None = None):
        cfg = model.cfg
        check_servable(cfg)
        has_local = any("local" in p for p, _ in model.runs)
        self.model = model
        self.cfg = cfg
        self.device = model.embed.device
        self.n_slots = n_slots
        self.temperature = temperature
        self.seed = seed

        # --- bucketed shape ladders (the shape contract) ---
        c_lo = pow2_ceil(max(cfg.window if has_local else 1, page_tokens))
        self.c_lo = c_lo
        self.batch_ladder = bucket_ladder(1, n_slots)
        self.cache_ladder = bucket_ladder(c_lo, max(max_cache_len, c_lo))
        self.p_lo = min_prefill
        self.prefill_ladder = bucket_ladder(
            min_prefill, max(pow2_floor(self.cache_ladder[-1] - 1), min_prefill))
        self.decode_shape_bound = len(self.batch_ladder) * len(self.cache_ladder)

        # resilience knobs: bounded pending queue (0 = unbounded), hot-set
        # position budget Bb*C (0 = unbounded; drives the "later" fits
        # verdict), and the per-boundary circuit breaker board the pool
        # consults at page ingest
        self.queue_bound = queue_bound
        self.max_hot_positions = max_hot_positions
        self.board = BreakerBoard(breaker)
        self.crash_recoveries = 0
        self._supervised = False
        self._deferred_free: list = []

        self.pool = PagedKVPool(page_tokens=page_tokens, bs=cfg.zebra_block_seq,
                                bc=cfg.zebra_block_ch, validation=validation,
                                breaker=self.board, tp=self._tensor_parallel(model),
                                kv_heads=cfg.n_kv_heads)
        self._decode_shapes: set[tuple[int, int]] = set()
        self._prefill_shapes: set[int] = set()
        # the data axis the lanes split over (None: one data rank), the
        # lanes this rank held at each batch bucket, and the broadcasts of
        # lanes from the data rank that holds them (count, host seconds)
        tp = self.pool.tp
        self._data = tp.data if tp is not None and tp.data.size > 1 else None
        self.hot_lanes: dict[int, int] = {}
        self.lane_broadcasts, self.seconds_broadcast = 0, 0.0

        # per-leaf batch axis of the cache tree (leaves are (B, ...) or,
        # in a stacked run, (count, B, ...)): diff two shape-only inits
        a = model.init_cache(3, c_lo, device="meta")
        b = model.init_cache(5, c_lo, device="meta")

        def _axis(sa, sb):
            d = [i for i, (x, y) in enumerate(zip(sa.shape, sb.shape)) if x != y]
            assert len(d) == 1, (sa.shape, sb.shape)
            return d[0]
        self._baxes = _tree_map(_axis, a, b)

        # --- hot working set ---
        self._Bb = self.batch_ladder[0]
        self._C = self.cache_ladder[0]
        self._hot = self._init_hot(self._Bb, self._C)
        self._lanes: list[Request | None] = [None] * self._Bb
        self._step_no = 0
        self.scheduler: Scheduler | None = None

    @staticmethod
    def _tensor_parallel(model: LM):
        """The layout of a model cut for a mesh (``model.mesh``), whose
        ranks each page their K/V heads; None in one process."""
        if getattr(model, "mesh", None) is None:
            return None
        from ..distributed.ctx import tensor_parallel
        from ..launch.steps import model_hints
        with model_hints(model):
            tp = tensor_parallel()
        if tp is None:
            raise NotImplementedError("ServeEngine serves a model cut for a mesh "
                                      "tensor-parallel only")
        return tp

    def _new_cache(self, B: int, C: int):
        with torch.inference_mode():
            return self.model.init_cache(B, C)

    def _init_hot(self, Bb: int, C: int):
        """This rank's lanes of a hot set of ``Bb`` lanes (:meth:`_block`)."""
        lo, hi = self._block(Bb)
        self.hot_lanes[Bb] = hi - lo
        return self._new_cache(hi - lo, C)

    def _block(self, Bb: int) -> tuple[int, int]:
        """The lanes ``[lo, hi)`` of a hot set of ``Bb`` this rank holds: its
        data rank's contiguous block where the data ranks divide ``Bb``,
        else every lane (the reference's ``batch_spec``)."""
        if self._data is None or Bb % self._data.size:
            return 0, Bb
        n = Bb // self._data.size
        return self._data.index * n, (self._data.index + 1) * n

    # ------------------------------------------------------------------
    # lane surgery (host-side, between steps)
    # ------------------------------------------------------------------
    def _take_lane(self, lane: int):
        """A copy of one lane of the hot set on every rank (:meth:`_take_lanes`)."""
        return self._take_lanes([lane])[0]

    def _take_lanes(self, lanes: list[int]) -> list:
        """A copy of each of ``lanes`` of the hot set on every rank (the
        next step writes the hot set again): where the lanes are split over
        ``data``, the copies of the data rank that holds them, broadcast
        over ``data`` in one call a holder."""
        lo, hi = self._block(self._Bb)
        n = hi - lo

        def take(lane):
            def one(x, a):
                if lo <= lane < hi:
                    return x.narrow(a, lane - lo, 1).clone()
                return x.new_empty(x.shape[:a] + (1,) + x.shape[a + 1:])
            return _tree_map(one, self._hot, self._baxes)
        subs = [take(lane) for lane in lanes]
        if n == self._Bb:
            return subs
        from ..distributed.collectives import dp_broadcast
        t0 = time.perf_counter()
        for src in sorted({lane // n for lane in lanes}):
            held = [i for i, lane in enumerate(lanes) if lane // n == src]
            leaves = []
            for i in held:
                _tree_map(leaves.append, subs[i])
            got = iter(dp_broadcast(leaves, self._data, src))
            for i in held:
                subs[i] = _tree_map(lambda _: next(got), subs[i])
            self.lane_broadcasts += 1
        self.seconds_broadcast += time.perf_counter() - t0
        return subs

    def _set_lane(self, hot, lane: int, sub):
        """Write a per-request tree into lane ``lane`` of ``hot`` (a hot set
        at this engine's bucket), in place, on the rank that holds it."""
        lo, hi = self._block(self._Bb)
        if not lo <= lane < hi:
            return hot

        def one(x, a, s):
            x.narrow(a, lane - lo, 1).copy_(s)
            return x
        return _tree_map(one, hot, self._baxes, sub)

    def _place(self, hot, lane: int, r: Request, sub, lanes) -> Any:
        hot = self._set_lane(hot, lane, sub)
        lanes[lane] = r
        return hot

    def _pad_like(self, sub, C: int):
        """Zero-pad a per-request tree (from prefill or page-in at an older,
        smaller bucket) at the end of each axis up to this engine's lane
        shapes at cache bucket ``C``. End padding is position-correct:
        global caches are position-indexed and rings stay at T ==
        window."""
        ref = self.model.init_cache(1, C, device="meta")

        def one(s, r):
            if s.shape == r.shape:
                return s
            assert all(x <= y for x, y in zip(s.shape, r.shape)), (s.shape, r.shape)
            out = s.new_zeros(r.shape)
            out[tuple(slice(0, n) for n in s.shape)] = s
            return out
        return _tree_map(one, sub, ref)

    # ------------------------------------------------------------------
    # admission / eviction
    # ------------------------------------------------------------------
    def _req_cache_bucket(self, r: Request) -> int:
        return pow2_bucket(max(r.total_len, self.c_lo), lo=self.c_lo,
                           hi=self.cache_ladder[-1])

    def _fits(self, r: Request, n_active: int | None = None) -> str:
        """Admission verdict: ``"never"`` = this engine can never cache the
        request (empty prompt, or a total beyond the ladder: terminal
        reject); ``"later"`` = admitting it now would exceed the hot-set
        position budget ``max_hot_positions`` (lanes x cache bucket), a
        transient condition that clears as lanes retire, so the scheduler
        keeps it queued; ``"ok"`` otherwise."""
        if r.prompt_len < 1:
            return "never"
        try:
            Cr = self._req_cache_bucket(r)
        except ValueError:
            return "never"
        if self.max_hot_positions > 0:
            if n_active is None:
                n_active = sum(x is not None for x in self._lanes)
            C = max(self._C, Cr)               # grow-only cache bucket
            Bb = pow2_bucket(max(n_active + 1, 1), lo=1, hi=self.n_slots)
            if Bb * C > self.max_hot_positions:
                # infeasible even alone -> never (C never shrinks here, so
                # waiting cannot help); otherwise transient
                if n_active == 0:
                    return "never"
                return "later"
        return "ok"

    def _min_ticks(self, r: Request) -> int:
        """Minimum engine ticks to finish ``r`` if admitted now: the slot
        clock the deadline-aware admission measures against
        (teacher-forced tail + decode, no queueing or preemption)."""
        if r.pos > 0:                          # resuming paged progress
            return max(r.total_len - 1 - r.pos, 0)
        fed = min(self._prefill_bucket(r.prompt_len), r.prompt_len - 1)
        return max(r.total_len - 1 - fed, 0)

    def _prefill_bucket(self, P: int) -> int:
        pb = pow2_floor(P)
        return pb if pb >= self.p_lo else 0

    def _admit_tree(self, r: Request):
        """Prefill (first admission) or page-in (re-admission after an
        eviction or a crash) one request; returns its per-request cache
        tree. Either way the caches cross the engine boundary in stream
        form: fresh prefills round-trip through the pool, so page ingest
        validation and byte metering cover admission traffic too."""
        if r.rid in self.pool and r.pos > 0:   # evicted/crashed: resume
            # the pos > 0 guard matters after a crash restore: a request
            # rolled back to before its first step may still have a
            # post-snapshot slab in the pool, but its restored
            # next_tok/fed bookkeeping belongs to the fresh-prefill path
            return self.pool.page_in(r.rid)
        P = r.prompt_len
        pb = self._prefill_bucket(P)
        if pb:
            if pb not in self.prefill_ladder:
                raise RuntimeError(f"prefill bucket {pb} outside ladder "
                                   f"{self.prefill_ladder}")
            self._prefill_shapes.add(pb)
            prompt = torch.as_tensor(np.asarray(r.prompt[:pb]), dtype=torch.int64,
                                     device=self.device)[None, :]
            _, (caches, _), _ = prefill(self.model, prompt, whole_batch=True)
        else:                                  # short prompt: decode-only
            caches = self._new_cache(1, self.c_lo)
        r.fed = min(pb, P - 1)                 # Pb == P replays last token
        r.pos = r.fed
        r.next_tok = int(r.prompt[r.fed])
        # pad to the ladder floor before paging out: prefill buckets below
        # page_tokens would otherwise fall to the dense leaf path; padded,
        # admission traffic rides the stream like eviction traffic (the
        # zero tail is all dead blocks, nearly free on the wire)
        self.pool.page_out(r.rid, self._pad_like(caches, self.c_lo))
        return self.pool.page_in(r.rid)

    def _evict(self, lane: int, tick: int) -> None:
        r = self._lanes[lane]
        self.pool.page_out(r.rid, self._take_lane(lane))
        self._lanes[lane] = None
        self.scheduler.preempt(r, tick)

    # ------------------------------------------------------------------
    def _schedule(self, tick: int, now: float) -> None:
        sched = self.scheduler
        for lane, r in enumerate(self._lanes):
            if r is not None and sched.should_preempt(r):
                self._evict(lane, tick)
        n_active = sum(r is not None for r in self._lanes)
        pending_admits = {"n": 0}

        def fits(r):
            # sequential admits within one tick see the growing batch
            v = self._fits(r, n_active + pending_admits["n"])
            if v == "ok":
                pending_admits["n"] += 1
            return v
        admitted = sched.admit(tick, self.n_slots - n_active, fits, eta=self._min_ticks)
        for r in admitted:
            r.t_submit = r.t_submit or now
        new_active = [r for r in self._lanes if r is not None] + admitted
        Bb = pow2_bucket(max(len(new_active), 1), lo=1, hi=self.n_slots)
        C = self._C
        for r in admitted:
            C = max(C, self._req_cache_bucket(r))
        if Bb == self._Bb and C == self._C:
            free = [i for i, r in enumerate(self._lanes) if r is None]
            for lane, r in zip(free, admitted):
                sub = self._pad_like(self._admit_tree(r), C)
                self._hot = self._place(self._hot, lane, r, sub, self._lanes)
            return
        # bucket change: rebuild the hot set at (Bb, C), carrying lanes (the
        # copies are taken before the old hot set is dropped)
        assert Bb in self.batch_ladder and C in self.cache_ladder, (Bb, C)
        held = [(lane, r) for lane, r in enumerate(self._lanes) if r is not None]
        carried = [(r, self._pad_like(sub, C)) for (_, r), sub in
                   zip(held, self._take_lanes([lane for lane, _ in held]))]
        self._hot = None
        hot = self._init_hot(Bb, C)
        lanes: list[Request | None] = [None] * Bb
        self._Bb, self._C = Bb, C
        for lane, (r, sub) in enumerate(carried + [(r, None) for r in admitted]):
            if sub is None:
                sub = self._pad_like(self._admit_tree(r), C)
            hot = self._place(hot, lane, r, sub, lanes)
        self._hot, self._lanes = hot, lanes

    # ------------------------------------------------------------------
    def _step(self, now: float) -> float:
        """One slotted decode step across every lane. Returns the wall clock
        after the tokens reached the host."""
        key = (self._Bb, self._C)
        if key not in self._decode_shapes:
            if self._Bb not in self.batch_ladder or self._C not in self.cache_ladder:
                raise RuntimeError(f"decode dispatch shape {key} outside "
                                   f"the bucketed ladder")
            self._decode_shapes.add(key)
            if len(self._decode_shapes) > self.decode_shape_bound:
                raise RuntimeError("decode dispatch shape count exceeded "
                                   f"its bound {self.decode_shape_bound}")
        lo, hi = self._block(self._Bb)
        mine = self._lanes[lo:hi]
        tok = torch.tensor([[r.next_tok if r else 0] for r in mine],
                           dtype=torch.int64, device=self.device)
        pos = torch.tensor([r.pos if r else 0 for r in mine],
                           dtype=torch.int64, device=self.device)
        generator = None
        if self.temperature > 0.0:
            # one draw stream per (seed, step), so a restored run re-draws
            # the steps it replays; SeedSequence mixes the pair into the 32
            # bits the CPU generator keeps of a seed
            generator = torch.Generator(device=self.device).manual_seed(int(
                np.random.SeedSequence((self.seed, self._step_no)).generate_state(1)[0]))
        self._step_no += 1
        nxt, _ = decode_slotted(self.model, tok, (self._hot, None), pos,
                                self.temperature, generator,
                                lanes=self._data if hi - lo < self._Bb else None)
        nxt_host = nxt[:, 0].tolist()          # device sync
        now = time.time()
        for lane, r in enumerate(self._lanes):
            if r is None:
                continue
            r.slot_steps += 1
            r.pos += 1
            if r.pos < r.prompt_len:           # teacher-forced prompt tail
                r.next_tok = int(r.prompt[r.pos])
                continue
            t = int(nxt_host[lane])
            r.out.append(t)
            r.next_tok = t
            r.token_times.append(now)
            if not r.t_first:
                r.t_first = now
        return now

    def _free_slab(self, rid) -> None:
        """Free a request's pool slab, deferred while supervised: a restore
        to the last snapshot rolls back post-snapshot retires and cancels,
        and their slabs must still be there to resume from. Deferred frees
        flush at the next snapshot (any later restore lands at or after
        it) or at the end of the run."""
        if self._supervised:
            self._deferred_free.append(rid)
        else:
            self.pool.free(rid)

    def _retire(self, now: float) -> None:
        for lane, r in enumerate(self._lanes):
            if r is not None and r.done:
                r.t_done = now
                self.scheduler.retire(r)
                self._free_slab(r.rid)
                self._lanes[lane] = None

    def _cancel_deadlines(self, tick: int) -> None:
        """Mid-flight SLO enforcement: a lane past its TTL is cancelled (shed
        with reason ``"deadline"``): finishing it late serves nobody and
        starves requests that can still meet theirs."""
        for lane, r in enumerate(self._lanes):
            if r is not None and r.deadline is not None \
                    and tick > r.deadline and not r.done:
                self._lanes[lane] = None
                self._free_slab(r.rid)
                self.scheduler.shed(r, "deadline")

    # ------------------------------------------------------------------
    # crash-recovery snapshots
    # ------------------------------------------------------------------
    def _snapshot(self, tick: int) -> dict:
        """Consistent restore point as of the start of ``tick``: every lane
        paged out to the pool (compressed and metered: snapshot traffic is
        real traffic) and a copy of the host bookkeeping. Lanes keep
        running from the dense hot set; the paged copy is read back only on
        restore."""
        for rid in self._deferred_free:       # committed: restores from
            self.pool.free(rid)               # now on land at >= this tick
        self._deferred_free.clear()
        held = [(lane, r) for lane, r in enumerate(self._lanes) if r is not None]
        for (_, r), sub in zip(held, self._take_lanes([lane for lane, _ in held])):
            self.pool.page_out(r.rid, sub)
        return {"tick": tick, "step_no": self._step_no,
                "Bb": self._Bb, "C": self._C,
                "lanes": [r.rid if r is not None else None for r in self._lanes],
                "sched": self.scheduler.snapshot()}

    def _restore(self, snap: dict) -> int:
        """Rebuild the engine at the snapshot: a fresh hot set, restored
        bookkeeping, and every formerly running lane requeued at the front
        of the queue (in lane order). Re-admission then goes through
        ``_admit_tree``'s pool-resume path, so recovery reuses the page-in
        machinery of preemption. Tokens generated before the snapshot are
        kept, not replayed. Returns the tick to resume at."""
        self.scheduler.restore(snap["sched"])
        self._step_no = snap["step_no"]
        self._Bb, self._C = snap["Bb"], snap["C"]
        self._hot = None
        self._hot = self._init_hot(self._Bb, self._C)
        self._lanes = [None] * self._Bb
        self._deferred_free.clear()           # those retires rolled back
        self.crash_recoveries += 1
        inflight = [rid for rid in snap["lanes"] if rid is not None]
        for rid in reversed(inflight):        # appendleft: keep lane order
            r = self.scheduler._all[rid]
            r.retries += 1
            if r.retries > r.retry_budget:
                self.pool.free(rid)
                self.scheduler.shed(r, "retry-budget")
                continue
            r.recovered = True
            self.scheduler.requeue_front(r)
        return snap["tick"]

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def run(self, requests: list[Request], *, preempt_after: int = 0,
            ft_cfg: FTConfig | None = None, snapshot_every: int = 1) -> dict:
        """Serve a trace to completion; returns the throughput report.

        With ``ft_cfg`` the loop is supervised: a snapshot every
        ``snapshot_every`` ticks, and a classified failure (an injected
        ``crash`` at site ``"engine_tick"``, say) restores the last snapshot
        after a jittered backoff instead of killing the run, bounded by
        ``ft_cfg.max_failures`` as in the training supervisor. Shed-policy
        classes are logged, never counted."""
        self.scheduler = Scheduler(requests, preempt_after=preempt_after,
                                   queue_bound=self.queue_bound)
        policy = FailurePolicy(ft_cfg) if ft_cfg is not None else None
        self._supervised = policy is not None
        self._deferred_free = []
        self.crash_recoveries = 0
        snap: dict | None = None
        snap_tick = -1
        tick = 0
        # the board clock is monotone over the engine's lifetime (advance()
        # keeps the max) but ticks restart per run: offset by the clock at
        # this run's start so probe deadlines scheduled in an earlier run
        # stay reachable
        board_base = self.board.now
        t0 = now = time.time()
        while True:
            try:
                if policy is not None and tick != snap_tick \
                        and tick % max(snapshot_every, 1) == 0:
                    snap = self._snapshot(tick)
                    snap_tick = tick
                crash_tap(tick)
                self.board.advance(board_base + tick)
                self._cancel_deadlines(tick)
                self._schedule(tick, now)
                # bound the queue after admission: what this tick's free
                # slots absorbed was never "pending", so a burst no wider
                # than the slots + bound must not shed at all
                self.scheduler.shed_overflow(tick)
                if not any(r is not None for r in self._lanes):
                    nxt = self.scheduler.next_arrival()
                    if nxt is None:
                        break
                    tick = max(tick + 1, nxt)  # idle until the next arrival
                    continue
                now = self._step(now)
                self._retire(now)
                if policy is not None:
                    policy.note_success()
                tick += 1
            except Exception as e:  # noqa: BLE001 — classified below
                if policy is None:
                    raise
                cls = ft_classify(e)
                if cls is None:
                    raise                      # a bug, not a fault
                pol = policy.record(cls, tick, e)
                if pol == "shed":
                    continue                   # already shed by the scheduler
                if not policy.count() or snap is None:
                    raise                      # budget exhausted / no restore
                delay = policy.backoff()
                if delay:
                    time.sleep(delay)
                tick = self._restore(snap)
                snap_tick = tick               # snap still valid for this tick
                continue
        for rid in self._deferred_free:
            self.pool.free(rid)
        self._deferred_free.clear()
        self._supervised = False
        wall = time.time() - t0
        return self.report(wall)

    # ------------------------------------------------------------------
    def report(self, wall: float) -> dict:
        # raises if any page's measured bytes leave the Eq. 2/3
        # index-padding bound: the per-page reconcile is load-bearing
        rec = self.pool.meter.reconcile(tol_bytes_per_map=1.0)
        done = [r for r in self.scheduler.completed if r.status == "done"]
        deltas = []
        for r in done:
            prev = r.t_submit
            for t in r.token_times:
                deltas.append(t - prev)
                prev = t
        deltas = np.asarray(sorted(deltas)) if deltas else np.zeros(1)
        kv = {"measured": 0, "predicted": 0.0, "dense": 0, "pages": 0}
        for r in done:
            rb = self.pool.request_bytes(r.rid)
            for k in kv:
                kv[k] += rb[k]
        n_tok = sum(len(r.out) for r in done)
        total = max(len(self.scheduler._all), 1)
        sched = self.scheduler
        return {
            "n_requests": len(done),
            "n_rejected": sum(1 for r in self.scheduler.completed
                              if r.status == "rejected"),
            # --- resilience (SLOs, crash recovery, breaker) ---
            "n_shed": sched.n_shed,
            "shed_frac": sched.n_shed / total,
            "deadline_misses": sched.deadline_misses,
            "deadline_miss_frac": sched.deadline_misses / total,
            "deferrals": sched.deferrals,
            "retries": sum(r.retries for r in sched._all.values()),
            "crash_recoveries": self.crash_recoveries,
            "recovered_requests": sum(1 for r in done if r.recovered),
            "breaker_trips": self.board.trips,
            "breaker_probes": self.board.probes,
            "breaker_tripped_sites": self.board.tripped_sites(),
            "breaker_labels": self.board.labels(),
            "breakers": self.board.snapshot(),
            "pages_breaker_dense": self.pool.n_breaker_dense,
            # --- throughput / latency / bytes ---
            "wall_s": wall,
            "requests_per_s": len(done) / wall if wall else 0.0,
            "tokens_per_s": n_tok / wall if wall else 0.0,
            "tokens": n_tok,
            "steps": self._step_no,
            "p50_token_ms": float(np.percentile(deltas, 50) * 1e3),
            "p95_token_ms": float(np.percentile(deltas, 95) * 1e3),
            "evictions": self.scheduler.evictions,
            "kv_bytes_measured": int(kv["measured"]),
            "kv_bytes_predicted": float(kv["predicted"]),
            "kv_bytes_dense": int(kv["dense"]),
            "kv_pages": int(kv["pages"]),
            "pages_recovered": self.pool.n_recovered,
            "zero_frac": self.pool.zero_frac(),
            "decode_shapes": len(self._decode_shapes),
            "decode_shape_bound": self.decode_shape_bound,
            "prefill_shapes": len(self._prefill_shapes),
            "prefill_shape_bound": len(self.prefill_ladder),
            "reconcile_max_delta_bytes": rec["max_abs_delta_bytes"],
        }
