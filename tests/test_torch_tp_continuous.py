"""Continuous serving under tensor parallelism (``launch.serve --requests
N --model-parallel N``) against the reference's ``ServeEngine`` on a
sharded model, on the CPU.

One module fixture runs both sides at once: the reference's engine at
``make_host_mesh(model=4)`` on 4 forced host devices (data 1), one JAX
subprocess a configuration (``tests/_torch_tp_continuous_cases.py::
reference_main``), beside one 4-rank ``gloo`` world of the port
(``port_rank``) that serves every run in turn, each rank on its shards of
the reference's parameters. The runs (``RUNS``) page K/V heads all three
ways a rank holds them (whole, gathered, on block edges), on ``fused``
and ``stream``, with ``validation="structural"``, preemption, deadlines
and a queue bound, and one supervised storm (a crash tick and six
truncated pages through a breaker that trips and closes) on the
configuration whose ranks each validate their own part of a page, at a
threshold where its heads' blocks die apart. The runs of ``DATA_RUNS``
go at (data 2, model 2) on both sides, in the same processes and the same
world (the decode lanes split over ``data`` where 2 divides the batch
bucket, whole on both data ranks elsewhere), and the port serves each
again at (data 1, model 4). One run of ``SAMPLED_RUNS``, granite drawn at
temperature 3.0, goes in the port's ranks alone at both layouts (the
reference draws from JAX's generator, not the port's).

Exact, on every rank and against the reference: every request's status,
shed reason and tokens; every report field but the wall-clock ones (KV
bytes measured, predicted and dense, pages, zero fraction, evictions,
shed, deadline misses, pages recovered, crash recoveries, breaker trips
and probes, steps, the decode and prefill shape counts); the pool meter's
records page by page; the decode and prefill shapes; the faults that
fired; for a (data 2, model 2) run the same again against the port's
(data 1, model 4) run, and every prefill site's whole-map observables
(rows, blocks, zero fraction, bytes) equal to that run's; for the sampled
run, every rank's requests, report, meter records, shapes and faults at
(data 2, model 2) equal to its (data 1, model 4) run's.

Fault readings, each made on a scratch copy of the package and each
failing this module: the pool's block geometry taken from a rank's own
heads (``_eff_blocks`` on the rank's ``k``: the 4-head gemma3-4b's pages
fall back to one 320-wide block and meter other bytes; 2 tests fail); the
count all-reduce left out of a ``page_out`` (each rank meters its own
live blocks; 8 fail); and a rank-local ingest verdict in the storm (a
rank whose part of a truncated page holds no live block keeps it
compressed while the others keep it dense: the breakers part ways and a
rank's collective meets another's, so the world aborts and every test
errors). At (data 2, model 2): the next tokens not gathered over
``data`` (``steps.decode_slotted`` returning this rank's lanes' alone: the
engine reads a lane another rank decodes, a rank raises, the world aborts
and every test errors); and a prefill run with the batch split over
``data`` (``ServeEngine._admit_tree`` calling ``prefill`` without
``whole_batch``: its sites count the one request once a data rank and the
MoE routes it twice: the reports still equal the reference's, the
sites' observables do not; 2 tests fail); and each data rank drawing
its own lanes' tokens from its own logits (``decode_slotted`` at a
temperature gathering the drawn tokens, not the logits: data rank 1
draws from the generator's first rows; 1 test fails). The fixture takes
~50 s.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_tp_continuous_cases as C
from repro_torch import configs

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
RANKS = range(C.MODEL)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({run: the reference's result}, the port's 4 rank results)."""
    from repro_torch.launch.mesh import spawn
    d = tmp_path_factory.mktemp("tp_continuous")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(TESTS)]),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={C.MODEL}",
               JAX_PLATFORMS="cpu")
    refs = {tag: subprocess.Popen(
        [sys.executable, "-c", "import sys, _torch_tp_continuous_cases as C; "
         "C.reference_main(sys.argv[1], sys.argv[2])", str(d), tag],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tag in C.CONFIGS}
    try:
        spawn(C.port_rank, len(RANKS), (str(d),), device="cpu")
    finally:
        errs = {tag: p.communicate(timeout=600)[1] for tag, p in refs.items()}
    for tag, p in refs.items():
        assert p.returncode == 0, errs[tag][-3000:]
    ref = {}
    for tag in C.CONFIGS:
        ref.update(np.load(d / f"ref_{tag}.npy", allow_pickle=True).item())
    return ref, [torch.load(d / f"rank{i}.pt", weights_only=False) for i in RANKS]


def _held(port, run: str) -> list:
    """The port's results of ``run`` held against the reference's: every
    rank's and, for a run of ``DATA_RUNS``, every rank's at (data 1, model
    4) too."""
    keys = [run] + ([C.AT_MODEL4.format(run)] if run in C.DATA_RUNS else [])
    return [p[k] for p in port for k in keys]


@pytest.mark.parametrize("run", list(C.ALL_RUNS))
def test_requests_and_report_equal_the_reference_on_every_rank(runs, run):
    ref, port = runs
    r = ref[run]
    assert r["report"]["kv_pages"] > 0 and r["report"]["n_requests"] > 0
    for got in _held(port, run):
        assert got["fired"] == r["fired"]
        assert got["requests"] == r["requests"]
        assert got["report"] == r["report"]
        assert got["decode_shapes"] == r["decode_shapes"]
        assert got["prefill_shapes"] == r["prefill_shapes"]


@pytest.mark.parametrize("run", list(C.ALL_RUNS))
def test_pool_meters_the_whole_pages_of_the_reference(runs, run):
    """The meter's records page by page (payload, index and dense bytes,
    live and total blocks), and some pages with dead blocks, some live."""
    ref, port = runs
    want = [tuple(x) for x in ref[run]["records"]]
    assert any(x[4] < x[5] for x in want) and any(x[4] > 0 for x in want)
    for got in _held(port, run):
        assert [tuple(x) for x in got["records"]] == want


def test_runs_exercise_the_engine_paths(runs):
    """Preemption, deadline and overload shedding over the runs; the storm
    crashed once, recovered its six truncated pages dense, tripped the
    breaker once and closed it, and fired the same faults as the reference
    on every rank."""
    ref, port = runs
    reps = [ref[run]["report"] for run in C.RUNS]
    assert sum(rep["evictions"] for rep in reps) > 0
    assert sum(rep["deadline_misses"] for rep in reps) > 0
    assert sum(rep["n_shed"] for rep in reps) > sum(rep["deadline_misses"] for rep in reps)
    storm = ref["gemma3_hd128_storm"]
    assert (storm["report"]["crash_recoveries"], storm["report"]["breaker_trips"]) == (1, 1)
    assert storm["report"]["pages_recovered"] == C.TRUNCATED
    assert storm["report"]["breakers"]["page"]["state"] == "closed"
    assert len(storm["fired"]) == C.TRUNCATED + 1
    for p in port:
        assert p["gemma3_hd128_storm"]["fired"] == storm["fired"]


@pytest.mark.parametrize("run", list(C.RUNS))
def test_ranks_page_their_heads_by_the_rule(runs, run):
    """Each rank's hot set holds its K/V heads (all of them where they do
    not split over 4), its pool packed and expanded the same compressed
    pages, and its sites ran by the engine's rules at the prefill buckets:
    the K/V map whole, gathered or on block edges as the pool's pages, the
    dense FFN's 64-column shards gathered."""
    _, port = runs
    tag, backend = C.RUNS[run][:2]
    cfg = C.config(tag, backend, configs)
    rule = C.KV_RULE[tag]
    heads = cfg.n_kv_heads if rule == "whole" else cfg.n_kv_heads // C.MODEL
    first = port[0][run]["pool"]
    for p in port:
        got = p[run]
        assert set(got["heads"]) == {heads}
        pool = got["pool"]
        assert {k: pool[k] for k in ("n_pages_out", "n_pages_in", "n_recovered",
                                     "n_breaker_dense", "bytes_out", "bytes_in")} == \
            {k: first[k] for k in ("n_pages_out", "n_pages_in", "n_recovered",
                                   "n_breaker_dense", "bytes_out", "bytes_in")}
        assert pool["n_pages_out"] > 0 and (pool["n_pages_in"] > 0 or C.RUNS[run][-1])
        kv = {s["rule"] for s in got["sites"] if s["site"] == "kv_cache"}
        assert kv == {rule}
        if tag.startswith("gemma3"):            # d_ff 256 a quarter a rank: gathered
            assert {s["rule"] for s in got["sites"] if s["site"] == "ffn_hidden"} == {"gather"}
        rows = {s["rows"] for s in got["sites"] if s["site"] == "kv_cache"}
        assert rows and rows <= {8, 16, 32}         # one request's prefill buckets


@pytest.mark.parametrize("run", list(C.DATA_RUNS))
def test_data_ranks_split_the_lanes(runs, run):
    """At (data 2, model 2) each rank holds ``Bb / 2`` lanes of a hot set
    of ``Bb`` where 2 divides it and all of them elsewhere, over buckets
    of 1 and 2 lanes (and 4 on 4 slots); at (data 1, model 4) all of them.
    Its pages take the K/V rule of 2 model ranks, and every prefill site's
    whole-map observables equal the (data 1, model 4) run's, one
    request's prefill bucket of rows each."""
    ref, port = runs
    tag, backend, kw = C.DATA_RUNS[run][:3]
    assert sorted(p["data_index2"] for p in port) == [0, 0, 1, 1]
    want = {1, 2} | ({4} if kw["n_slots"] == 4 else set())
    keys = ("site", "rows", "n_total", "zero_frac", "measured_bytes")
    for p in port:
        got, one = p[run], p[C.AT_MODEL4.format(run)]
        assert set(got["hot_lanes"]) >= want
        assert got["hot_lanes"] == {b: b // 2 if b % 2 == 0 else b for b in got["hot_lanes"]}
        assert one["hot_lanes"] == {b: b for b in got["hot_lanes"]}
        assert {s["rule"] for s in got["sites"] if s["site"] == "kv_cache"} == \
            {C.DATA_KV_RULE[tag]}
        assert [{k: s[k] for k in keys} for s in got["sites"]] == \
            [{k: s[k] for k in keys} for s in one["sites"]]
        rows = {s["rows"] for s in got["sites"] if s["site"] == "kv_cache"}
        assert rows and rows <= {8, 16, 32}
    rep = ref[run]["report"]
    assert rep["evictions"] > 0
    if C.DATA_RUNS[run][-1]:
        assert (rep["crash_recoveries"], rep["pages_recovered"]) == (1, C.TRUNCATED)


@pytest.mark.parametrize("run", list(C.SAMPLED_RUNS))
def test_sampled_tokens_equal_the_one_data_rank_run(runs, run):
    """A run drawn at a temperature at (data 2, model 2), its draws made
    from the logits of every lane gathered over ``data``, equals on every
    rank the port's (data 1, model 4) run at the same seed: statuses,
    shed reasons, tokens, report, meter records and shapes. Its lanes split
    where 2 divides the bucket, and its tokens are not the greedy run's."""
    ref, port = runs
    greedy = ref[run.removesuffix("_sampled")]["requests"]
    one = port[0][C.AT_MODEL4.format(run)]
    assert one["report"]["kv_pages"] > 0 and one["report"]["n_requests"] > 0
    assert {rid: t for rid, (_, _, t) in one["requests"].items()} != \
        {rid: t for rid, (_, _, t) in greedy.items()}
    for p in port:
        for got in (p[run], p[C.AT_MODEL4.format(run)]):
            for k in ("requests", "report", "fired", "records", "decode_shapes",
                      "prefill_shapes"):
                assert got[k] == one[k], k
        assert 2 in p[run]["hot_lanes"]
        assert p[run]["hot_lanes"] == {b: b // 2 if b % 2 == 0 else b
                                       for b in p[run]["hot_lanes"]}
