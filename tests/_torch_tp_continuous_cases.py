"""The runs of ``tests/test_torch_tp_continuous.py`` and the two programs
that serve them: :func:`reference_main` (the reference's ``ServeEngine``
at ``make_host_mesh(model=4)`` on 4 forced host devices, data 1, one JAX
process a configuration) and :func:`port_rank` (one rank of the port's
4-rank ``gloo`` world on the CPU, a (data 1, model 4) mesh, that serves
every run in turn on the same engine arguments). The runs of
``DATA_RUNS`` go at (data 2, model 2) on both sides, in the same
processes (``make_host_mesh(model=2)``), and the port serves each again at
(data 1, model 4).

The configurations are reduced and in float32, and between them they
page K/V heads all three ways a rank can hold them at 4 model ranks:
- the reduced gemma3-4b as it is: 2 KV heads do not split over 4, so every
  rank holds them all and packs each page whole (counted once);
- gemma3-4b with 4 KV heads: a rank's one 320-wide head cuts the whole
  page's 128-wide blocks, so its pages are gathered over ``model``;
- granite-moe-1b-a400m with 8 KV heads of 64, and gemma3-4b with 4 of
  128: a rank's heads are one 128-wide block, packed as they are.
gemma3-4b is cut to one local and one global layer (the ring beside the
global cache); granite routes its experts over ``model`` (expert
parallelism) at decode batches of 1 and 2 lanes. The supervised storm
runs on gemma3-4b with heads of 128 at T_obj 3.5, where a page's blocks
die head by head.

At (data 2, model 2) the decode lanes split over ``data`` where 2 divides
the batch bucket and run whole on both data ranks elsewhere (1 lane, and
every prefill): the reduced gemma3-4b on 4 slots takes the hot set from 1
to 2 to 4 lanes, with evictions, preemption and a supervised storm (a
crash and truncated pages, so snapshots and restores move split lanes);
granite routes its experts over the global batch gathered over ``data``
at 2 lanes and over the whole batch at 1. The same granite run drawn at
temperature 3.0 (``SAMPLED_RUNS``) runs in the port's ranks alone, at
(data 2, model 2) and at (data 1, model 4).

The reference draws its parameters once a configuration and writes them
(the port's dotted names, ``models.lm.convert.port_params``) before it
compiles anything; the port's ranks wait for that file. This module
imports numpy only at the top: the port's ranks import it without JAX.
"""
from __future__ import annotations

import os

import numpy as np

from _torch_tp_cases import _records, _wait

MODEL = 4
SEED = 0
COMMON = dict(param_dtype="float32", compute_dtype="float32")
# tag: (architecture, fields replaced, T_obj)
# gemma3-4b cut to one local and one global layer (the ring and the global
# cache; the reduced config's six layers would triple the compiles)
GEMMA3 = dict(n_layers=2, layer_pattern=("local", "global"))
CONFIGS = {
    "gemma3": ("gemma3-4b", GEMMA3, 2.45),
    "gemma3_kv4": ("gemma3-4b", dict(GEMMA3, n_kv_heads=4), 2.45),
    "granite_kv8": ("granite-moe-1b-a400m", dict(n_kv_heads=8), 0.025),
    # 4 heads of 128: a rank's one head is a block, and at T_obj 3.5 a
    # page's blocks die head by head, so a truncated page may leave a rank
    # with no live block to cut (its own validation passes) while the
    # others fail theirs: the storm's verdicts must be agreed
    "gemma3_hd128": ("gemma3-4b", dict(GEMMA3, n_heads=4, n_kv_heads=4, head_dim=128), 3.5),
}
# the K/V layout each configuration's pages take on a rank
KV_RULE = {"gemma3": "whole", "gemma3_kv4": "gather", "granite_kv8": "blocks",
           "gemma3_hd128": "blocks"}
# run tag: (configuration, backend, engine arguments, trace, run arguments,
# supervised storm)
# eight requests arriving one a tick into 2 slots, a queue bound of 2, a
# 22-tick TTL, preemption after 4 steps: overload and deadline sheds,
# evictions, every prefill bucket (8, 16, 32); gemma3-4b's 4-head run takes
# 4 slots
ENGINE = dict(n_slots=2, max_cache_len=64, page_tokens=16, validation="structural",
              queue_bound=2)
TRACE = dict(requests=8, vocab=512, seed=2, prompt_lo=5, prompt_hi=40, gen_lo=4, gen_hi=12,
             arrival_every=1, deadline_ticks=22)
# granite has no local layer, so its cache floor is the page: pages of 32
# keep its prefill buckets (up to 32 here) inside it, as both engines need
# (ROADMAP.md, section 3)
GRANITE = dict(ENGINE, page_tokens=32)
RUNS = {
    "gemma3_fused": ("gemma3", "fused", ENGINE, TRACE, 4, False),
    "gemma3_kv4_stream": ("gemma3_kv4", "stream", dict(ENGINE, n_slots=4), TRACE, 4, False),
    "granite_kv8_fused": ("granite_kv8", "fused", GRANITE, TRACE, 4, False),
    # serve_chaos_bench's storm: a crash at tick 6 and six truncated pages
    # through a breaker that trips and closes again, supervised
    "gemma3_hd128_storm": ("gemma3_hd128", "stream", dict(ENGINE, n_slots=4, queue_bound=4),
                           dict(TRACE, requests=6, seed=0, gen_lo=2, gen_hi=8,
                                deadline_ticks=96), 0, True),
}
# (data, model) of the runs below, each also served by the port at (1, 4)
DATA_MESH = (2, 2)
DATA_RUNS = {
    "gemma3_fused_d2": ("gemma3", "fused", dict(ENGINE, n_slots=4, queue_bound=4),
                        dict(TRACE, deadline_ticks=96), 4, True),
    "granite_kv8_stream_d2": ("granite_kv8", "stream", GRANITE, TRACE, 4, False),
}
# K/V layout of each configuration's pages at 2 model ranks
DATA_KV_RULE = {"gemma3": "gather", "granite_kv8": "blocks"}
ALL_RUNS = {**RUNS, **DATA_RUNS}
# runs that draw their tokens at a temperature, the port's alone (the
# reference draws from JAX's generator): at DATA_MESH and again at (data 1,
# model 4), each lane's draw made from the logits gathered over ``data``
SAMPLED_RUNS = {
    "granite_kv8_stream_d2_sampled": ("granite_kv8", "stream",
                                  dict(GRANITE, temperature=3.0, seed=3), TRACE, 4, False),
}
PORT_RUNS = {**ALL_RUNS, **SAMPLED_RUNS}
# the port's key for a run of DATA_RUNS at (data 1, model 4)
AT_MODEL4 = "{}@1x4"
BREAKER = dict(trip_after=3, window=64, probe_after=1, probe_backoff=2.0, probe_cap=8,
               close_after=2)
CRASH_TICK, TRUNCATED = 6, 6
FIELDS = ("n_requests", "n_rejected", "n_shed", "deadline_misses", "deferrals", "retries",
          "crash_recoveries", "recovered_requests", "breaker_trips", "breaker_probes",
          "breaker_tripped_sites", "breaker_labels", "breakers", "pages_breaker_dense",
          "tokens", "steps", "evictions", "kv_bytes_measured", "kv_bytes_predicted",
          "kv_bytes_dense", "kv_pages", "pages_recovered", "zero_frac", "decode_shapes",
          "decode_shape_bound", "prefill_shapes", "prefill_shape_bound",
          "reconcile_max_delta_bytes")


def config(tag: str, backend: str, pkg):
    arch, fields, t_obj = CONFIGS[tag]
    return pkg.reduced(arch).replace(**COMMON, **fields, zebra_backend=backend,
                                     zebra_t_obj=t_obj,
                                     zebra_sites=("ffn_hidden", "kv_cache"))


def trace(pkg, spec: dict):
    spec = dict(spec)
    return pkg.synthetic_trace(spec.pop("requests"), **spec)


def _serve(pkg, eng, run: str, ft_cfg, inject, Fault):
    """One run on an engine of either package: (report, every request's
    (status, shed reason, tokens), the faults that fired)."""
    _, _, _, spec, preempt, storm = PORT_RUNS[run]
    reqs = trace(pkg, spec)
    if not storm:
        rep = eng.run(reqs, preempt_after=preempt)
        fired = []
    else:
        with inject(Fault("crash", site="engine_tick", arg=CRASH_TICK),
                    Fault("truncate", site="page", times=TRUNCATED)) as plan:
            rep = eng.run(reqs, preempt_after=preempt,
                          ft_cfg=ft_cfg(max_failures=4, backoff_base_s=0.0, jitter_seed=0))
        fired = list(plan.injected)
    outs = {r.rid: (r.status, r.shed_reason, list(r.out)) for r in eng.scheduler.completed}
    return {k: rep[k] for k in FIELDS}, outs, fired


def reference_main(out_dir: str, tag: str) -> None:
    """Every run of configuration ``tag`` through the reference's engine at
    ``make_host_mesh(model=4)``, and those of ``DATA_RUNS`` at
    ``DATA_MESH``: its report, requests, faults, meter records and
    dispatch shapes."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from repro import configs, serve
    from repro.distributed import sharding as shd
    from repro.ft import BreakerConfig, Fault, FTConfig, inject
    from repro.launch.mesh import make_host_mesh
    from repro.models.lm import LM
    from repro_torch import configs as tconfigs
    from repro_torch.models.lm import LM as TLM
    from repro_torch.models.lm.convert import port_params

    mesh = make_host_mesh(model=MODEL)
    cfg = config(tag, "fused", configs)
    params = jax.jit(LM(cfg).init)(jax.random.PRNGKey(SEED))
    flat = port_params(TLM(config(tag, "fused", tconfigs)),
                       jax.tree_util.tree_map(np.asarray, params))
    np.savez(f"{out_dir}/params_{tag}.tmp.npz", **flat)
    os.replace(f"{out_dir}/params_{tag}.tmp.npz", f"{out_dir}/params_{tag}.npz")
    meshes = {MODEL: mesh, DATA_MESH[1]: make_host_mesh(model=DATA_MESH[1])}
    on = {m: jax.device_put(params, jax.tree_util.tree_map(
        lambda s, mesh=mesh: NamedSharding(mesh, s), shd.param_specs(params, cfg, mesh),
        is_leaf=lambda x: isinstance(x, PartitionSpec))) for m, mesh in meshes.items()}
    out = {}
    for run, (ctag, backend, kw, _, _, storm) in ALL_RUNS.items():
        if ctag != tag:
            continue
        m = DATA_MESH[1] if run in DATA_RUNS else MODEL
        model = LM(config(tag, backend, configs))
        eng = serve.ServeEngine(model, on[m], meshes[m], **kw,
                                breaker=BreakerConfig(**BREAKER) if storm else None)
        rep, outs, fired = _serve(serve, eng, run, FTConfig, inject, Fault)
        out[run] = {"report": rep, "requests": outs, "fired": fired,
                    "records": _records(eng.pool.meter),
                    "decode_shapes": sorted(eng._decode_shapes),
                    "prefill_shapes": sorted(eng._prefill_shapes)}
    np.save(f"{out_dir}/ref_{tag}.npy", np.asarray(out, dtype=object), allow_pickle=True)


def port_rank(rank: int, out_dir: str) -> None:
    """One rank: every run through the port's engine on this rank's shards
    of the reference's parameters, its sites recorded; those of
    ``DATA_RUNS`` and ``SAMPLED_RUNS`` at ``DATA_MESH`` and again at (data
    1, model 4) (``AT_MODEL4``). Saves ``rank<r>.pt``."""
    import torch

    from repro_torch import configs, serve
    from repro_torch.core.engine import record_tp_sites, tp_sites_on_host
    from repro_torch.distributed.sharding import shard_model_
    from repro_torch.ft import BreakerConfig, Fault, FTConfig, inject
    from repro_torch.launch import serve as launch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM

    torch.set_num_threads(1)            # 4 ranks share the host's cores
    mesh = make_host_mesh(model=MODEL, device="cpu")
    mesh2 = make_host_mesh(model=DATA_MESH[1], device="cpu")
    res = {"model_index": mesh.get_local_rank("model"), "data_index":
           mesh.get_local_rank("data"), "model_index2": mesh2.get_local_rank("model"),
           "data_index2": mesh2.get_local_rank("data")}
    flats = {}
    jobs = [(run, run, mesh) for run in RUNS]
    for run in [*DATA_RUNS, *SAMPLED_RUNS]:
        jobs += [(run, run, mesh2), (run, AT_MODEL4.format(run), mesh)]
    for run, key, on in jobs:
        tag, backend, kw, _, _, storm = PORT_RUNS[run]
        if tag not in flats:
            _wait(f"{out_dir}/params_{tag}.npz")
            flats[tag] = dict(np.load(f"{out_dir}/params_{tag}.npz"))
        model = LM(config(tag, backend, configs)).requires_grad_(False)
        with torch.no_grad():
            for name, t in model.state_dict().items():
                t.copy_(torch.from_numpy(flats[tag][name]))
        shard_model_(model, on)
        eng = serve.ServeEngine(model, **kw, breaker=BreakerConfig(**BREAKER) if storm else None)
        with record_tp_sites() as sites:
            rep, outs, fired = _serve(serve, eng, run, FTConfig, inject, Fault)
        res[key] = {"report": rep, "requests": outs, "fired": fired,
                    "records": _records(eng.pool.meter),
                    "decode_shapes": sorted(eng._decode_shapes),
                    "prefill_shapes": sorted(eng._prefill_shapes),
                    "sites": [{k: s[k] for k in ("site", "rule", "rows", "width", "split",
                                                 "n_total", "zero_frac", "measured_bytes")}
                              for s in tp_sites_on_host(sites)],
                    "heads": [leaf.shape[-2] for leaf in _leaves(eng._hot)],
                    "hot_lanes": dict(eng.hot_lanes),
                    "pool": {k: getattr(eng.pool, k) for k in launch.POOL_COUNTERS}}
    torch.save(res, f"{out_dir}/rank{rank}.pt")


def _leaves(tree) -> list:
    from repro_torch.utils import map_tree
    out = []
    map_tree(lambda _, leaf: out.append(leaf), tree)
    return out
