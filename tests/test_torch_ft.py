"""The port's fault-tolerance package (``repro_torch.ft``) against the
reference's (``repro.ft``): the failure taxonomy, the circuit breaker's
state machine (the scenarios of ``tests/test_resilience.py``, run on both
packages) and the fault injectors, each corruption bit for bit on the same
numpy inputs."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ft.breaker as jbreaker
import repro.ft.faults as jfaults
import repro_torch.ft.breaker as tbreaker
import repro_torch.ft.faults as tfaults
from repro.compress import compress as jcompress
from repro_torch.compress import compress as tcompress

from _torch_parity import bits

# the packages export a function ``inject`` under the module's own name
jinject = importlib.import_module("repro.ft.inject")
tinject = importlib.import_module("repro_torch.ft.inject")

BREAKERS = pytest.mark.parametrize("mod", [jbreaker, tbreaker], ids=["reference", "port"])


# ---------------------------------------------------------------------------
# The failure taxonomy
# ---------------------------------------------------------------------------

def _exceptions(mod):
    return [mod.CorruptStream("bad"), mod.TransientStep("x"), mod.PoisonBatch("x"),
            mod.DeviceLoss("x"), mod.DeadlineExceeded("x"), mod.Overload("x"),
            mod.FaultError("base"), RuntimeError("UNAVAILABLE: socket closed"),
            OSError("connection reset by peer"), RuntimeError("loss is NaN"),
            FloatingPointError("overflow"), ValueError("typo"), KeyboardInterrupt(),
            RuntimeError("some INTERNAL failure"), AssertionError("bug")]


def test_classify_and_policies_match_reference():
    got = [(c.__name__ if c else None, tfaults.policy_for(e))
           for e in _exceptions(tfaults) for c in [tfaults.classify(e)]]
    want = [(c.__name__ if c else None, jfaults.policy_for(e))
            for e in _exceptions(jfaults) for c in [jfaults.classify(e)]]
    assert got == want
    assert {k.__name__: v for k, v in tfaults.POLICIES.items()} == \
        {k.__name__: v for k, v in jfaults.POLICIES.items()}
    assert tfaults.SHED_POLICIES == jfaults.SHED_POLICIES


def test_card_out_of_memory_is_transient():
    """The card's OOM error is XLA's RESOURCE_EXHAUSTED: restore and retry."""
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert tfaults.classify(oom) is tfaults.TransientStep
    assert tfaults.policy_for(oom) == "restore-retry"
    assert jfaults.policy_for(RuntimeError("RESOURCE_EXHAUSTED: out of memory")) \
        == "restore-retry"


# ---------------------------------------------------------------------------
# The circuit breaker
# ---------------------------------------------------------------------------

@BREAKERS
def test_breaker_trips_after_threshold_in_window(mod):
    br = mod.CircuitBreaker("page", mod.BreakerConfig(trip_after=3, window=8))
    br.record_failure(0)
    br.record_failure(1)
    assert br.state == mod.CLOSED and br.trips == 0
    br.record_failure(2)
    assert br.state == mod.OPEN and br.trips == 1 and br.failures_seen == 3


@BREAKERS
def test_breaker_window_decay_prevents_trip(mod):
    br = mod.CircuitBreaker("page", mod.BreakerConfig(trip_after=3, window=4))
    for t in (0, 10, 20, 30, 40):
        br.record_failure(t)
    assert br.state == mod.CLOSED and br.trips == 0


@BREAKERS
def test_breaker_open_skips_then_probes_half_open(mod):
    br = mod.CircuitBreaker("page", mod.BreakerConfig(trip_after=1, probe_after=4))
    br.record_failure(0)
    assert br.state == mod.OPEN
    assert not br.allow(1) and not br.allow(3) and br.skipped == 2
    assert br.allow(4) and br.state == mod.HALF_OPEN
    assert br.allow(4)


@BREAKERS
def test_breaker_probe_fail_reopens_on_decayed_schedule(mod):
    br = mod.CircuitBreaker("page", mod.BreakerConfig(trip_after=1, probe_after=2,
                                                      probe_backoff=2.0, probe_cap=8))
    br.record_failure(0)
    probe_ticks, t = [], 0
    for _ in range(5):
        while not br.allow(t):
            t += 1
        probe_ticks.append(t)
        br.record_failure(t)
    assert [b - a for a, b in zip(probe_ticks, probe_ticks[1:])] == [4, 8, 8, 8]
    assert br.probe_fails == 5 and br.probes == 5
    assert br.state == mod.OPEN and br.trips == 1


@BREAKERS
def test_breaker_closes_after_consecutive_passes(mod):
    cfg = mod.BreakerConfig(trip_after=1, probe_after=1, close_after=2)
    br = mod.CircuitBreaker("page", cfg)
    br.record_failure(0)
    assert br.allow(1) and br.state == mod.HALF_OPEN
    br.record_success(1)
    assert br.state == mod.HALF_OPEN
    br.record_success(1)
    assert br.state == mod.CLOSED and br.probe_passes == 2
    br2 = mod.CircuitBreaker("page", cfg)
    br2.record_failure(0)
    br2.allow(1)
    br2.record_success(1)
    br2.record_failure(1)
    assert br2.state == mod.OPEN
    br2.allow(3)
    br2.record_success(3)
    assert br2.state == mod.HALF_OPEN


@BREAKERS
def test_breaker_label_snapshot_and_board(mod):
    br = mod.CircuitBreaker("page", mod.BreakerConfig(trip_after=1))
    br.record_failure(0)
    assert br.label() == "page:open(trips=1,probes=0,skipped=0)"
    assert br.snapshot()["state"] == mod.OPEN and br.snapshot()["failures_seen"] == 1
    board = mod.BreakerBoard(mod.BreakerConfig(trip_after=1, probe_after=2))
    board.advance(5)
    assert board.allow("page")
    board.record_failure("page")
    board.record_failure("ring")
    assert board.tripped_sites() == ["page", "ring"] and board.trips == 2
    assert not board.allow("page")
    board.advance(3)
    assert board.now == 5
    board.advance(7)
    assert board.allow("page") and board.get("page").state == mod.HALF_OPEN
    assert [l.split("(")[0] for l in board.labels()] == ["page:half_open", "ring:open"]


@BREAKERS
def test_breaker_scope_contextvar(mod):
    assert mod.active_board() is None
    board = mod.BreakerBoard()
    with mod.breaker_scope(board):
        assert mod.active_board() is board
        with mod.breaker_scope(mod.BreakerBoard()) as inner:
            assert mod.active_board() is inner
        assert mod.active_board() is board
    assert mod.active_board() is None


def test_breaker_board_replays_reference_on_random_events():
    """A seeded stream of consults and verdicts over three sites: the two
    boards agree on every answer and every snapshot."""
    rng = np.random.default_rng(7)
    cfg = dict(trip_after=2, window=6, probe_after=3, probe_backoff=2.0, probe_cap=12,
               close_after=2)
    jb, tb = jbreaker.BreakerBoard(jbreaker.BreakerConfig(**cfg)), \
        tbreaker.BreakerBoard(tbreaker.BreakerConfig(**cfg))
    for _ in range(400):
        site = ["page", "serve", "ring"][rng.integers(3)]
        op = rng.integers(4)
        if op == 0:
            jb.tick(), tb.tick()
        elif op == 1:
            assert jb.allow(site) == tb.allow(site)
        elif op == 2:
            jb.record_failure(site), tb.record_failure(site)
        else:
            jb.record_success(site), tb.record_success(site)
        assert jb.snapshot() == tb.snapshot() and jb.now == tb.now


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------

def _stream(seed, nb=24, bs=8, bc=16, n_live=10):
    rng = np.random.default_rng(seed)
    payload = np.zeros((nb, bs, bc), np.float32)
    payload[:n_live] = rng.uniform(0.5, 2.0, size=(n_live, bs, bc)) * \
        rng.choice([-1.0, 1.0], size=(n_live, bs, bc))
    bitmap = np.zeros(nb, np.int8)
    bitmap[rng.choice(nb, n_live, replace=False)] = 1
    return payload, bitmap.reshape(4, nb // 4), np.int32(n_live)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kind,arg,n_live", [("bitflip", 5, 10), ("bitflip", 77, 10),
                                             ("truncate", 0, 10), ("truncate", 0, 0),
                                             ("nan", 3, 10), ("nan", 40, 10),
                                             ("value", 3, 10), ("value", 3, 0),
                                             ("count", 0, 10)])
def test_stream_tap_corrupts_like_reference(kind, arg, n_live, dt):
    """Each kind bites at the reference's slot, bit and value, in the
    payload's dtype; a tap with no plan armed returns its inputs."""
    payload, bitmap, nl = _stream(1, n_live=n_live)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    jp = jnp.asarray(payload).astype(jdt)
    tp = torch.from_numpy(np.asarray(jp).view(np.int32 if dt == "f32" else np.int16)
                          .copy()).view(tdt)
    tb, tn = torch.from_numpy(bitmap), torch.tensor(nl)
    assert tinject.stream_tap(tp, tb, tn, site="engine:x") == (tp, tb, tn)
    with jinject.inject(jinject.Fault(kind, site="engine:x", arg=arg)) as jplan:
        jout = jinject.stream_tap(jp, jnp.asarray(bitmap), jnp.int32(nl), site="engine:x")
    with tinject.inject(tinject.Fault(kind, site="engine:x", arg=arg)) as tplan:
        tout = tinject.stream_tap(tp, tb, tn, site="engine:x")
        assert tinject.stream_tap(tp, tb, tn, site="engine:x") == (tp, tb, tn)  # spent
    assert jplan.injected == tplan.injected == [(kind, "engine:x")]
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(bits(t), bits(np.asarray(j)))
    assert torch.equal(tb, torch.from_numpy(bitmap))           # inputs untouched


def test_fault_plan_take_matches_reference():
    def run(mod):
        plan = mod.FaultPlan([mod.Fault("nan", site="a", times=2),
                              mod.Fault("value", site="*", arg=4),
                              mod.Fault("count", site="b", times=-1)])
        seq = [("a", ("nan",)), ("b", ("nan", "count")), ("a", ("nan",)),
               ("a", ("nan",)), ("c", ("value",)), ("b", ("count",)), ("c", ("value",))]
        return [None if f is None else (f.kind, f.arg)
                for f in (plan.take(k, s) for s, k in seq)]
    assert run(tinject) == run(jinject)


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("kind", tinject.STREAM_KINDS)
def test_corrupt_map_matches_reference(kind, checksum):
    """``corrupt_map`` on the same compressed map: payload, index, n_live
    bit for bit, and the checksum carried over unchanged."""
    rng = np.random.default_rng(3)
    keep = rng.random((8, 4)) > 0.5
    x = (rng.normal(size=(64, 512)) * np.repeat(np.repeat(keep, 8, 0), 128, 1)) \
        .astype(np.float32)
    jcm = jcompress(jnp.asarray(x).astype(jnp.bfloat16), bs=8, bc=128, checksum=checksum)
    tcm = tcompress(torch.from_numpy(x).to(torch.bfloat16), bs=8, bc=128, checksum=checksum)
    np.testing.assert_array_equal(bits(tcm.payload), bits(np.asarray(jcm.payload)))
    jbad = jinject.corrupt_map(jcm, kind, arg=2)
    tbad = tinject.corrupt_map(tcm, kind, arg=2)
    for f in ("payload", "index", "n_live"):
        np.testing.assert_array_equal(bits(getattr(tbad, f)), bits(np.asarray(getattr(jbad, f))))
    if checksum:
        assert int(tbad.checksum) == int(np.uint32(jbad.checksum)) == int(tcm.checksum)
    else:
        assert tbad.checksum is None and jbad.checksum is None
    fresh = tcompress(torch.from_numpy(x).to(torch.bfloat16), bs=8, bc=128)
    for f in ("payload", "index", "n_live"):          # the source map is untouched
        assert torch.equal(bits_of(getattr(tcm, f)), bits_of(getattr(fresh, f)))


def bits_of(t):
    return t.view(torch.int16) if t.is_floating_point() else t
