"""The port's continuous-batching engine on the CPU against the reference's
(``repro.serve``): the slotted decode with per-lane positions, the
scheduler, the paged compressed-KV pool and the supervised engine.

Both engines serve the reduced gemma3-4b with the same parameters (the
reference's ``jax.jit(model.init)(PRNGKey(0))``, carried across with
``convert.from_jax_params``) at ``serve_bench``'s operating point
(``ffn_hidden`` and ``kv_cache`` sites, T_obj 3.45), in float32: with
bf16 weights XLA's CPU dot of a float32 activation by a converted bf16
weight is ~1e-4 off an exact float32 product, which flips the ``kv_cache``
blocks whose maximum sits near T_obj (2 of the bf16 trace's 1,920 page
blocks; ``test_serve_bench_bf16_port``). In float32 the two packages' maps
agree to ~3e-6 and every page's bitmap is the same. Held bit for bit:
greedy tokens, the report's byte fields, pages, zero fraction, steps,
evictions, shape counts and the resilience counters.

The reference's jitted prefill, decode and page codec are compiled once
for the module and shared by its engines (each engine would compile its
own). Times in the docstrings: one run of the case on this CPU, one
thread for the port (``one_thread``: two port runs compare bit for bit).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.ft import BreakerConfig as JBreakerConfig
from repro.ft import Fault as JFault
from repro.ft import FTConfig as JFTConfig
from repro.ft import inject as jinject
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_decode_slotted, make_prefill
from repro.models.lm import LM as JLM
from repro.models.lm import attention as jattn
from repro.models.lm import blocks as jblocks
from repro.serve import PagedKVPool as JPool
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.serve import synthetic_trace as jtrace
from repro_torch import configs
from repro_torch.ft import ENGINE_TICK_SITE, BreakerConfig, Fault, FTConfig, TransientStep
from repro_torch.ft import crash_tap, inject
from repro_torch.launch import serve
from repro_torch.models.lm import LM
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import blocks
from repro_torch.models.lm.convert import from_jax_params
from repro_torch.serve import (PagedKVPool, Request, ServeEngine, bucket_ladder,
                               pow2_bucket, pow2_ceil, pow2_floor, synthetic_trace)

from _torch_parity import bits, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

# serve_bench / serve_chaos_bench's model and trace, in float32 (module
# docstring)
KW = dict(param_dtype="float32", compute_dtype="float32",
          zebra_sites=("ffn_hidden", "kv_cache"), zebra_t_obj=3.45)
TRACE = dict(vocab=512, seed=0, prompt_lo=8, prompt_hi=48, gen_lo=8, gen_hi=16)
# serve_chaos_bench's storm
CHAOS_TRACE = dict(TRACE, arrival_every=1)
BREAKER = dict(trip_after=3, window=64, probe_after=1, probe_backoff=2.0, probe_cap=8,
               close_after=2)
REPORT_FIELDS = ("n_requests", "n_rejected", "n_shed", "deadline_misses", "deferrals",
                 "retries", "crash_recoveries", "recovered_requests", "breaker_trips",
                 "breaker_probes", "breaker_tripped_sites", "breaker_labels", "breakers",
                 "pages_breaker_dense", "tokens", "steps", "evictions",
                 "kv_bytes_measured", "kv_bytes_predicted", "kv_bytes_dense", "kv_pages",
                 "pages_recovered", "zero_frac", "decode_shapes", "decode_shape_bound",
                 "prefill_shapes", "prefill_shape_bound", "reconcile_max_delta_bytes")


# ---------------------------------------------------------------------------
# Fixtures (module-cached: one model per package, one compile per shape)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref():
    cfg = jconfigs.reduced("gemma3-4b").replace(**KW)
    mesh = make_host_mesh(model=1)
    model = JLM(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    jits = {"prefill": jax.jit(make_prefill(model, mesh)),
            "decode": jax.jit(make_decode_slotted(model, mesh, 0.0),
                              donate_argnums=JEngine.DONATE_ARGNUMS),
            "enc": {}, "dec": {}}
    return model, params, mesh, jits


@functools.lru_cache(maxsize=None)
def _port():
    model, params, _, _ = _ref()
    cfg = configs.reduced("gemma3-4b").replace(**KW)
    return from_jax_params(LM(cfg).requires_grad_(False), params)


def _ref_engine(**kw) -> JEngine:
    model, params, mesh, jits = _ref()
    eng = JEngine(model, params, mesh, **kw)
    eng._prefill, eng._decode = jits["prefill"], jits["decode"]
    eng.pool._enc = jits["enc"].setdefault(eng.pool.validation, {})
    eng.pool._dec = jits["dec"]
    return eng


def _engines(**kw):
    return _ref_engine(**kw), ServeEngine(_port(), **kw)


def _prompt(n, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, size=n).astype(np.int32)


def _outs(eng) -> dict:
    return {r.rid: (r.status, r.shed_reason, list(r.out)) for r in eng.scheduler.completed}


def _same_run(jeng, jrep, peng, prep) -> None:
    """The two engines served the trace alike: every request's status and
    tokens, and every report field but the wall-clock ones."""
    assert _outs(peng) == _outs(jeng)
    got = {k: prep[k] for k in REPORT_FIELDS}
    want = {k: jrep[k] for k in REPORT_FIELDS}
    assert got == want


def _both_run(trace_fn, run_kw=None, **kw):
    jeng, peng = _engines(**kw)
    jrep = jeng.run(trace_fn(jtrace, JRequest), **(run_kw or {}))
    prep = peng.run(trace_fn(synthetic_trace, Request), **(run_kw or {}))
    _same_run(jeng, jrep, peng, prep)
    return jeng, jrep, peng, prep


# ---------------------------------------------------------------------------
# Buckets and the scheduler's trace
# ---------------------------------------------------------------------------

def test_pow2_helpers():
    """The ladder helpers, as the reference's test pins them (<0.1 s)."""
    assert [pow2_ceil(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
    assert [pow2_floor(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 2, 4, 8, 8]
    assert pow2_bucket(1, lo=8) == 8
    assert pow2_bucket(20, lo=8) == 32
    assert pow2_bucket(32, lo=8, hi=32) == 32
    with pytest.raises(ValueError):
        pow2_bucket(33, lo=8, hi=32)
    assert bucket_ladder(8, 64) == (8, 16, 32, 64)
    assert bucket_ladder(1, 1) == (1,)


def test_synthetic_trace_matches_reference():
    """The same numpy draws: the same prompts, lengths, arrivals and
    deadlines (<0.1 s)."""
    got = synthetic_trace(6, vocab=262144, seed=0, prompt_lo=128, prompt_hi=512, gen_lo=8,
                          gen_hi=32, arrival_every=2, deadline_ticks=50)
    want = jtrace(6, vocab=262144, seed=0, prompt_lo=128, prompt_hi=512, gen_lo=8,
                  gen_hi=32, arrival_every=2, deadline_ticks=50)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert (a.rid, a.max_new, a.arrival, a.deadline) == (b.rid, b.max_new, b.arrival,
                                                             b.deadline)


def test_crash_tap_fires_only_at_named_tick():
    """The engine-tick tap raises at its named tick only, once (<0.1 s)."""
    crash_tap(3)                               # no plan armed
    with inject(Fault("crash", site=ENGINE_TICK_SITE, arg=3)) as plan:
        crash_tap(2)
        with pytest.raises(TransientStep, match="tick 3"):
            crash_tap(3)
        crash_tap(3)                           # times=1: consumed
    assert plan.injected == [("crash", "engine_tick")]


# ---------------------------------------------------------------------------
# Per-lane decode against the reference
# ---------------------------------------------------------------------------

def test_cache_write_per_lane_equals_reference_bitwise():
    """``cache[b, slot[b]] = new[b, 0]`` in place equals the reference's
    ``where(hit, new, cache)``; the ``int`` path is unchanged (~0.8 s, the
    reference's first dispatches)."""
    rng = np.random.default_rng(0)
    cache = rng.normal(size=(3, 8, 2, 4)).astype(np.float32)
    new = rng.normal(size=(3, 1, 2, 4)).astype(np.float32)
    slot = np.array([0, 7, 3])
    want = jblocks._cache_write(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(slot))
    got = blocks._cache_write(torch.from_numpy(cache.copy()), torch.from_numpy(new),
                              torch.from_numpy(slot))
    assert np.array_equal(bits(got), bits(want))
    want = jblocks._cache_write(jnp.asarray(cache), jnp.asarray(new), 5)
    got = blocks._cache_write(torch.from_numpy(cache.copy()), torch.from_numpy(new), 5)
    assert np.array_equal(bits(got), bits(want))


@pytest.mark.parametrize("window", [0, 8])
def test_attend_decode_per_lane_matches_reference(window):
    """(B,) positions on a ring of T = 8: lane 0 before the window fills,
    lane 1 after it wrapped, lane 2 on its last slot; each lane alone
    through the ``int`` path gives its row bit for bit (~1 s)."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(3, 8, 2, 16)).astype(np.float32) for _ in range(2))
    pos = np.array([2, 13, 7])
    want = jattn.attend_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos), window=window)
    got = attn.attend_decode(*(torch.from_numpy(a) for a in (q, k, v)),
                             torch.from_numpy(pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for b in range(3):                         # each lane as the int path alone
        one = attn.attend_decode(*(torch.from_numpy(a[b:b + 1]) for a in (q, k, v)),
                                 int(pos[b]), window=window)
        assert torch.equal(one, got[b:b + 1])


def test_decode_step_per_lane_matches_reference():
    """One slotted decode step of the reduced gemma3-4b (window 32) at
    positions (5, 40, 63): lane 1's local slot wrapped (40 % 32 = 8). The
    logits agree at 1e-4, every cache position no lane wrote is untouched
    and the written ones agree at 1e-5 (~7-10 s, most of it the reference
    model's init, which the module's later cases reuse)."""
    jmodel, params, _, _ = _ref()
    model = _port()
    B, C = 3, 64
    rng = np.random.default_rng(2)
    jc = jmodel.init_cache(B, C)
    leaves, tdef = jax.tree_util.tree_flatten(jc)
    fills = [rng.normal(size=x.shape).astype(np.float32) for x in leaves]
    jc = jax.tree_util.tree_unflatten(tdef, [jnp.asarray(f) for f in fills])
    pc = model.init_cache(B, C)
    pleaves = []
    serve._map_leaves(lambda i, leaf: pleaves.append(leaf), pc)
    for leaf, f in zip(pleaves, fills):
        leaf.copy_(torch.from_numpy(f))
    tok = np.array([[3], [17], [400]])
    pos = np.array([5, 40, 63])
    jl, (jc2, _) = jmodel.decode_step(params, jnp.asarray(tok, jnp.int32), (jc, None),
                                       jnp.asarray(pos, jnp.int32))
    with torch.inference_mode():
        pl, _ = model.decode_step(torch.from_numpy(tok), (pc, None), torch.from_numpy(pos))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for leaf, f, want in zip(pleaves, fills, jax.tree_util.tree_leaves(jc2)):
        T = f.shape[1]
        hit = np.zeros(f.shape[:2], bool)
        hit[np.arange(B), pos % T] = True
        got = leaf.numpy()
        assert np.array_equal(got[~hit], f[~hit])
        np.testing.assert_allclose(got[hit], np.asarray(want)[hit], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The pool
# ---------------------------------------------------------------------------

def _pool_tree(rng):
    k = rng.normal(size=(1, 32, 2, 32)).astype(np.float32)
    k[:, 16:] = 0.0                            # pages 1.. all dead
    v = np.zeros((1, 32, 2, 32), np.float32)   # every page all dead
    odd = rng.normal(size=(3, 5)).astype(np.float32)
    return {"k": k, "v": v, "odd": odd}


def test_slab_round_trip_bitwise_including_all_dead_pages():
    """page_out -> page_in is bitwise, with live and all-zero pages and a
    dense odd-shape leaf; the bytes, pages and zero fraction equal the
    reference pool's on the same tree (~0.5 s)."""
    tree = _pool_tree(np.random.default_rng(7))
    pool = PagedKVPool(page_tokens=16, bs=8, bc=128)
    pool.page_out(0, {n: torch.from_numpy(a) for n, a in tree.items()})
    back = pool.page_in(0)
    for n, a in tree.items():
        assert np.array_equal(bits(back[n]), bits(a))
    jpool = JPool(page_tokens=16, bs=8, bc=128)
    jpool.page_out(0, {n: jnp.asarray(a) for n, a in tree.items()})
    assert pool.n_pages_out == jpool.n_pages_out == 4
    assert pool.request_bytes(0) == jpool.request_bytes(0)
    assert pool.zero_frac() == jpool.zero_frac()
    assert (pool.bytes_out, pool.n_recovered) == (jpool.bytes_out, 0)
    rb = pool.request_bytes(0)
    assert 0 < rb["measured"] < rb["dense"] and rb["pages"] == 4
    assert 0 in pool
    pool.free(0)
    assert 0 not in pool


@pytest.mark.parametrize("kind,level", [("bitflip", "checksum"), ("truncate", "structural"),
                                        ("nan", "structural"), ("value", "checksum"),
                                        ("count", "structural")])
def test_page_ingest_fault_degrades_one_page(kind, level):
    """A corrupt page is detected (against the plan's record), kept dense,
    and the request still round-trips bitwise; the bytes equal the
    reference pool's under the same fault (0.2-2 s: the reference codec's
    compile at each validation level)."""
    rng = np.random.default_rng(3)
    k = rng.normal(size=(1, 32, 2, 32)).astype(np.float32)
    pool = PagedKVPool(page_tokens=16, validation=level)
    with inject(Fault(kind, site="page")) as plan:
        pool.page_out(5, {"k": torch.from_numpy(k)})
    assert plan.injected == [(kind, "page")]
    assert pool.n_recovered == 1 and pool.n_pages_out == 1
    assert np.array_equal(bits(pool.page_in(5)["k"]), bits(k))
    jpool = JPool(page_tokens=16, validation=level)
    with jinject(JFault(kind, site="page")):
        jpool.page_out(5, {"k": jnp.asarray(k)})
    assert pool.request_bytes(5) == jpool.request_bytes(5)
    assert pool.request_bytes(5)["pages"] == 1


# ---------------------------------------------------------------------------
# The engine against the reference
# ---------------------------------------------------------------------------

def test_serve_bench_matches_reference_and_sequential():
    """serve_bench's trace (8 requests, T_obj 3.45, page 16, structural):
    the port at 4 slots equals the reference at 4 slots (tokens, bytes,
    pages, zero fraction, steps, shapes), and the port at 1 slot gives the
    same tokens and KV bytes: continuous batching changes no token (17-23
    s, most of it the reference's compiles of the module's shapes)."""
    kw = dict(max_cache_len=128, page_tokens=16, validation="structural")
    jeng, peng = _engines(n_slots=4, **kw)
    jrep = jeng.run(jtrace(8, **TRACE))
    prep = peng.run(synthetic_trace(8, **TRACE))
    _same_run(jeng, jrep, peng, prep)
    assert prep["n_requests"] == 8 and prep["kv_pages"] == 192
    assert prep["kv_bytes_measured"] < prep["kv_bytes_dense"]
    seq = ServeEngine(_port(), n_slots=1, **kw)
    srep = seq.run(synthetic_trace(8, **TRACE))
    assert {rid: o for rid, o in _outs(seq).items()} == _outs(peng)
    for k in ("kv_bytes_measured", "kv_bytes_predicted", "kv_bytes_dense", "kv_pages",
              "zero_frac", "n_requests"):
        assert srep[k] == prep[k], k
    assert srep["decode_shapes"] == 1 and prep["decode_shapes"] == 3


def test_serve_bench_bf16_port():
    """serve_bench in bf16, as the bench runs: continuous == sequential in
    the port, and the dense bytes and page count of BENCH_serve.json
    (3,932,160 over 192 pages). Its measured bytes (1,257,856) do not
    reproduce in either package here: jax's default threefry draw gives
    other weights (the reference then measures 1,218,944 at zero fraction
    0.6901; with the old non-partitionable draw 1,255,808, one bf16 block
    off the record), and the port measures 1,214,848 on the reference's
    weights, two blocks off the reference (module docstring) (~4-5 s)."""
    jmodel, params, _, _ = _ref()
    cfg = configs.reduced("gemma3-4b").replace(**dict(KW, param_dtype="bfloat16",
                                                      compute_dtype="bfloat16"))
    bf16_params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    model = from_jax_params(LM(cfg).requires_grad_(False), bf16_params)
    kw = dict(max_cache_len=128, page_tokens=16, validation="structural")
    reps, outs = [], []
    for slots in (4, 1):
        eng = ServeEngine(model, n_slots=slots, **kw)
        reps.append(eng.run(synthetic_trace(8, **TRACE)))
        outs.append(_outs(eng))
    assert outs[0] == outs[1]
    for k in ("kv_bytes_measured", "kv_bytes_predicted", "kv_pages", "zero_frac"):
        assert reps[0][k] == reps[1][k], k
    assert (reps[0]["kv_bytes_dense"], reps[0]["kv_pages"]) == (3932160, 192)
    assert reps[0]["kv_bytes_measured"] - reps[0]["kv_bytes_predicted"] == 144.0


def test_chaos_storm_matches_reference():
    """serve_chaos_bench's storm (6 requests arriving one a tick, 4 slots,
    queue bound 4, deadline 96 ticks, a crash at tick 12 and 6 truncated
    pages, the bench's breaker) on both engines, supervised: the same
    faults, crash recovery, breaker trip and reclosing, shed counts and
    tokens; and the port's storm tokens equal its clean run's (9-11 s)."""
    def storm(eng, trace_fn, fault, ft, inj):
        trace = trace_fn(6, **CHAOS_TRACE, deadline_ticks=96)
        with inj(fault("crash", site="engine_tick", arg=12),
                 fault("truncate", site="page", times=6)) as plan:
            rep = eng.run(trace, ft_cfg=ft(max_failures=4, backoff_base_s=0.0,
                                           jitter_seed=0))
        return rep, list(plan.injected)

    kw = dict(n_slots=4, max_cache_len=128, page_tokens=16, validation="structural",
              queue_bound=4)
    jeng = _ref_engine(breaker=JBreakerConfig(**BREAKER), **kw)
    jrep, jinj = storm(jeng, jtrace, JFault, JFTConfig, jinject)
    peng = ServeEngine(_port(), breaker=BreakerConfig(**BREAKER), **kw)
    prep, pinj = storm(peng, synthetic_trace, Fault, FTConfig, inject)
    _same_run(jeng, jrep, peng, prep)
    assert pinj == jinj and len(pinj) == 7
    assert (prep["crash_recoveries"], prep["breaker_trips"]) == (1, 1)
    assert prep["breakers"]["page"]["state"] == "closed"
    assert prep["pages_recovered"] == 6 and prep["n_requests"] == 6
    clean = ServeEngine(_port(), breaker=BreakerConfig(**BREAKER), **kw)
    clean.run(synthetic_trace(6, **CHAOS_TRACE, deadline_ticks=96),
              ft_cfg=FTConfig(max_failures=4, backoff_base_s=0.0, jitter_seed=0))
    assert _outs(clean) == _outs(peng)


def test_continuous_matches_one_shot():
    """The slotted engine's tokens == the one-shot prefill + generate path
    (``serve_one_shot``) for the same prompt, greedy, and == the reference
    engine's: chunked admission (power-of-two prefix prefill, teacher-forced
    tail) is invisible in the output (~1.5-2 s)."""
    P, G = 20, 8                               # P+G = 28: both cache at 32
    prompt = _prompt(P, seed=11)
    kw = dict(n_slots=1, max_cache_len=32)
    _, _, peng, _ = _both_run(lambda tr, R: [R(rid=0, prompt=prompt, max_new=G)], **kw)
    served = peng.scheduler.completed[0].out
    one = serve.serve_one_shot(_port(), torch.from_numpy(prompt.astype(np.int64))[None], G,
                               log=lambda *_: None)
    assert served == one["tokens"][0].tolist()


@pytest.mark.parametrize("P", [5, 16])
def test_short_prompt_and_exact_power_of_two_admission(P):
    """P = 5 (below min_prefill 8): no prefill, teacher-forced from pos 0;
    P = 16 (Pb == P): prefill 16, the last prompt token replayed at pos
    15. Both engines agree (tokens, bytes, shapes) (~2 s and ~0.3 s)."""
    G = 6
    prompt = _prompt(P, seed=4)
    _, _, peng, prep = _both_run(lambda tr, R: [R(rid=0, prompt=prompt, max_new=G)],
                                 n_slots=1, max_cache_len=32, min_prefill=8)
    assert peng._prefill_shapes == (set() if P < 8 else {16})
    assert len(peng.scheduler.completed[0].out) == G


def test_eviction_under_pressure():
    """Slot pressure + preemption (2 slots, preempt after 3): requests are
    evicted to the pool and resume, every request's tokens equal the run
    without preemption, and both engines agree on the evictions, pages and
    bytes (~2-3 s)."""
    def trace(tr, R):
        return [R(rid=i, prompt=_prompt(10 + 3 * i, seed=20 + i), max_new=6)
                for i in range(4)]
    kw = dict(n_slots=2, max_cache_len=64)
    _, _, peng, prep = _both_run(trace, run_kw=dict(preempt_after=3), **kw)
    assert prep["evictions"] > 0
    assert any(r.evictions for r in peng.scheduler.completed)
    base = ServeEngine(_port(), **kw)
    brep = base.run(trace(synthetic_trace, Request))
    assert {k: v[2] for k, v in _outs(base).items()} == {k: v[2] for k, v in
                                                         _outs(peng).items()}
    assert prep["kv_pages"] > brep["kv_pages"]


def test_cache_bucket_change_mid_run():
    """Cache ladder (32, 64): a request whose total needs 64 arrives while
    one at 32 is in flight; the hot set is rebuilt at (2, 64) with the
    running lane carried over, in both engines alike (~1 s)."""
    def trace(tr, R):
        return [R(rid=0, prompt=_prompt(12, seed=1), max_new=10),
                R(rid=1, prompt=_prompt(30, seed=2), max_new=20, arrival=3)]
    _, _, peng, prep = _both_run(trace, n_slots=2, max_cache_len=64)
    assert peng.cache_ladder == (32, 64)
    assert peng._decode_shapes >= {(1, 32), (2, 64)}
    assert prep["n_requests"] == 2


def test_fits_verdicts_match_reference():
    """``_fits``: never (empty prompt; total beyond the ladder; over the
    hot-position budget even alone), later (over the budget beside the
    active lanes), ok (<0.1 s)."""
    kw = dict(n_slots=2, max_cache_len=64, max_hot_positions=64)
    jeng, peng = _engines(**kw)
    reqs = [(0, 10, 6), (1, 30, 20), (2, 60, 30), (3, 0, 4)]
    got, want = [], []
    for n_active in (0, 1):
        for rid, P, G in reqs:
            prompt = _prompt(P, seed=rid)
            got.append(peng._fits(Request(rid=rid, prompt=prompt, max_new=G), n_active))
            want.append(jeng._fits(JRequest(rid=rid, prompt=prompt, max_new=G), n_active))
    assert got == want == ["ok", "ok", "never", "never", "ok", "later", "never", "never"]
    tight = ServeEngine(_port(), n_slots=2, max_cache_len=64, max_hot_positions=32)
    assert tight._fits(Request(rid=1, prompt=_prompt(30), max_new=20), 0) == "never"


def test_engine_refuses_what_the_reference_refuses():
    """Encoder stacks (whisper), recurrent layer types (recurrentgemma)
    and a local window that is not a power of two (~0.1 s)."""
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServeEngine(LM(configs.reduced("whisper-medium")))
    with pytest.raises(NotImplementedError, match="recurrent state"):
        ServeEngine(LM(configs.reduced("recurrentgemma-2b")))
    with pytest.raises(ValueError, match="power of two"):
        ServeEngine(LM(configs.reduced("gemma3-4b").replace(window=24)))


def test_deadlines_and_queue_bound():
    """8 requests arriving one a tick into 2 slots, a queue bound of 2, a
    14-tick TTL, preemption after 4 steps: overload sheds, a deadline shed
    at admission and one of a request that had made progress, the same in
    both engines (~1 s)."""
    def trace(tr, R):
        return tr(8, vocab=512, seed=3, prompt_lo=8, prompt_hi=24, gen_lo=4, gen_hi=12,
                  arrival_every=1, deadline_ticks=14)
    _, _, peng, prep = _both_run(trace, run_kw=dict(preempt_after=4), n_slots=2,
                                 max_cache_len=64, queue_bound=2)
    shed = [r for r in peng.scheduler.completed if r.status == "shed"]
    reasons = [r.shed_reason for r in shed]
    assert "overload" in reasons and "deadline" in reasons
    assert any(r.shed_reason == "deadline" and r.pos > 0 for r in shed)
    assert any(r.shed_reason == "deadline" and r.pos == 0 for r in shed)
    assert prep["deadline_misses"] == reasons.count("deadline")
    assert prep["n_requests"] == 8 - len(shed)


def test_retry_budget_exhausted_and_unsupervised_crash():
    """A crash at each of ticks 4-7: the lanes in flight through all four
    use up their re-admissions (retry_budget 3: a restore rolls retries
    back to the snapshot's count, so the crashes must fall at successive
    snapshots) and are shed, the later arrival finishes; both engines
    agree. Unsupervised, a crash re-raises (~2 s)."""
    def trace(tr, R):
        return [R(rid=i, prompt=_prompt(9 + i, seed=i), max_new=12, arrival=5 * i)
                for i in range(3)]
    jeng, peng = _engines(n_slots=2, max_cache_len=32)
    with jinject(*(JFault("crash", site="engine_tick", arg=t) for t in range(4, 8))):
        jrep = jeng.run(trace(jtrace, JRequest),
                        ft_cfg=JFTConfig(max_failures=8, backoff_base_s=0.0))
    with inject(*(Fault("crash", site="engine_tick", arg=t) for t in range(4, 8))):
        prep = peng.run(trace(synthetic_trace, Request),
                        ft_cfg=FTConfig(max_failures=8, backoff_base_s=0.0))
    _same_run(jeng, jrep, peng, prep)
    reasons = [r.shed_reason for r in peng.scheduler.completed]
    assert "retry-budget" in reasons and prep["crash_recoveries"] == 4
    assert prep["n_requests"] >= 1
    eng = ServeEngine(_port(), n_slots=2, max_cache_len=32)
    with inject(Fault("crash", site="engine_tick", arg=2)), \
            pytest.raises(TransientStep, match="tick 2"):
        eng.run(trace(synthetic_trace, Request))


def test_cli_continuous_on_cpu(capsys):
    """``--requests`` on the CPU: the reduced config served through the
    engine, the three report lines printed; with ``--model-parallel 2``
    two spawned ranks serve a trace as one process does: every request's
    tokens and the report's KV bytes and pages (~10 s)."""
    out = serve.main(["--reduced", "--device", "cpu", "--requests", "4", "--slots", "2",
                      "--prompt-len", "48", "--gen", "8", "--t-obj", "2.45", "--backend",
                      "fused", "--validate", "structural", "--deadline-ticks", "200",
                      "--queue-bound", "4", "--supervise"])
    rep = out["report"]
    assert rep["n_requests"] == 4 and rep["kv_pages"] > 0
    text = capsys.readouterr().out
    assert "continuous: 4 requests" in text and "KV stream:" in text
    argv = ["--reduced", "--device", "cpu", "--requests", "2", "--slots", "2",
            "--prompt-len", "24", "--gen", "4", "--t-obj", "2.45", "--backend", "stream"]
    one = serve.main(argv)
    tp = serve.main([*argv, "--model-parallel", "2"])
    assert len(tp["ranks"]) == 2
    assert tp["requests"] == _outs(one["engine"])
    assert {k: tp["report"][k] for k in ("kv_bytes_measured", "kv_pages", "zero_frac")} == \
        {k: one["report"][k] for k in ("kv_bytes_measured", "kv_pages", "zero_frac")}


def test_sampling_is_seeded():
    """At temperature > 0 each step draws from a generator seeded by the
    engine's seed and the step number: the same seed gives the same
    tokens, another seed other ones (only greedy is held against the
    reference, whose ``fold_in`` keys torch cannot draw) (~1 s)."""
    def run(seed):
        eng = ServeEngine(_port(), n_slots=2, max_cache_len=32, temperature=5.0, seed=seed)
        eng.run([Request(rid=i, prompt=_prompt(9 + i, seed=i), max_new=8) for i in range(2)])
        return _outs(eng)
    assert run(1) == run(1)
    assert run(1) != run(2)
