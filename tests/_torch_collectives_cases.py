"""The inputs of ``tests/test_torch_collectives.py`` and the two programs
that run them: :func:`reference_main` (the reference under ``shard_map``
on 8 forced host devices, one process) and :func:`port_rank` (one rank of
the port's 8-rank ``gloo`` world on the CPU). Both lay the ranks out as
the reference's collectives bench does: a (data 2, model 4) mesh, rank =
data index * 4 + model index.

Every input comes from numpy seeds, so both programs see the same values.
This module imports numpy only at the top: the port's ranks import it
without JAX.
"""
from __future__ import annotations

import numpy as np

BS, BC = 8, 128
M, K = 64, 512                       # the all-gather and psum shards
AG_CASES = (("zf64", 0.64, None), ("zf90", 0.9, None), ("dead", 0.64, 2))
PSUM_CASES = ("int", "float")
BYTES = np.arange(8, dtype=np.int64) * 7 + 300_000_001   # sum ~2.4e9 > 2**31
# the layer exchanges on the reduced gemma3-4b: d 128, 2 KV heads of 320
EX_B, EX_S = 2, 32                   # batch and tokens per model shard
T_LAYER_OUT = 3.5                    # N(0, 1) maps: ~0.6 of the 8x128 blocks dead
T_KV = 3.5
# the data-parallel MoE on the reduced granite-moe-1b-a400m, one row a rank
MOE_S, MOE_T_OBJ = 32, 0.025
# the collectives bench's shards (benchmarks/collectives_bench.py)
BM, BK, BENCH_ZF = 256, 1024, 0.64
BENCH_SEEDS = {"model": (4, 7), "data": (2, 11)}
# the faults bench's ring rows (benchmarks/faults_bench.py::bench_ring)
FAULTS = (("drop_hop_structural", "all_gather", "structural", "bench", 2),
          ("drop_hop_checksum", "all_gather", "checksum", "bench", 2),
          ("psum_drop_hop", "psum", "checksum", "p", 1))


def masked(rng, n, m, k, zf, integer: bool) -> np.ndarray:
    keep = (rng.random((n, m // BS, k // BC)) > zf).astype(np.float32)
    x = (rng.integers(-8, 9, size=(n, m, k)).astype(np.float32) if integer
         else rng.standard_normal((n, m, k)).astype(np.float32))
    return x * np.repeat(np.repeat(keep, BS, 1), BC, 2)


def ag_shards(zf: float, dead) -> np.ndarray:
    sh = masked(np.random.default_rng(3), 4, M, K, zf, True)
    if dead is not None:
        sh[dead] = 0.0
    return sh


def psum_shards(kind: str) -> np.ndarray:
    return masked(np.random.default_rng({"int": 5, "float": 8}[kind]), 4, M, K, 0.64,
                  kind == "int")


def bench_shards(axis: str) -> np.ndarray:
    """``collectives_bench._make_shards``: integer-valued (n, 256, 1024)."""
    n, seed = BENCH_SEEDS[axis]
    rng = np.random.default_rng(seed)
    keep = (rng.random((n, BM // BS, BK // BC)) > BENCH_ZF).astype(np.float32)
    vals = rng.integers(-8, 9, size=(n, BM, BK)).astype(np.float32)
    return vals * np.repeat(np.repeat(keep, BS, axis=1), BC, axis=2)


def fault_shards() -> np.ndarray:
    """``faults_bench.bench_ring``'s (4, 256, 1024) maps."""
    rng = np.random.default_rng(6)
    keep = rng.random((4, BM // BS, BK // BC)) > BENCH_ZF
    return rng.normal(size=(4, BM, BK)).astype(np.float32) \
        * np.repeat(np.repeat(keep, BS, 1), BC, 2)


def exchange_inputs(d: int, hkv: int, hd: int):
    """(y (B, 4S, d), k, v (B, 4S, hkv, hd)): the full sequences, each
    model shard holding S of the tokens."""
    rng = np.random.default_rng(9)
    y = rng.standard_normal((EX_B, 4 * EX_S, d)).astype(np.float32)
    k = rng.standard_normal((EX_B, 4 * EX_S, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((EX_B, 4 * EX_S, hkv, hd)).astype(np.float32)
    return y, k, v


def moe_inputs(d: int, f: int, E: int):
    """The MoE's parameters (the reference's layout: router (d, E), expert
    stacks (E, d, f) and (E, f, d)) and x (8, S, d): one row a rank."""
    rng = np.random.default_rng(12)
    p = {"router": rng.standard_normal((d, E)) / np.sqrt(d),
         "w_gate": rng.standard_normal((E, d, f)) / np.sqrt(d * f),
         "w_up": rng.standard_normal((E, d, f)) / np.sqrt(d * f),
         "w_down": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    x = rng.standard_normal((8, MOE_S, d))
    return ({k: v.astype(np.float32) for k, v in p.items()}, x.astype(np.float32))


def _stream(n_live, m, k) -> int:
    return int(n_live) * BS * BC * 4 + ((m // BS) * (k // BC) + 7) // 8


def live_blocks(x: np.ndarray) -> int:
    m, k = x.shape
    return int((np.abs(x).reshape(m // BS, BS, k // BC, BC).max((1, 3)) > 0).sum())


# ---------------------------------------------------------------------------
# The reference: one process, 8 forced host devices
# ---------------------------------------------------------------------------

def reference_main(path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    import repro.configs as jconfigs
    from repro.compress import integrity
    from repro.core.zebra import ZebraConfig
    from repro.distributed import collectives as coll
    from repro.distributed.ctx import comm_context
    from repro.ft import Fault, inject
    from repro.launch.mesh import _make_mesh
    from repro.models.lm.attention import gather_kv_shards
    from repro.models.lm.ffn import ffn_layer_out_exchange, moe_apply_dp

    mesh = _make_mesh((2, 4), ("data", "model"))
    ALL = ("data", "model")
    out, labels = {}, {}

    def sm(f, in_specs, out_specs):
        return jax.jit(coll.shard_map_compat(f, mesh, in_specs=in_specs,
                                             out_specs=out_specs))

    def dev(v):                       # a per-device value, stacked (8, ...)
        return jnp.asarray(v)[None]

    rows = P("model", None)
    for tag, zf, dead in AG_CASES:
        X = jnp.asarray(ag_shards(zf, dead).reshape(4 * M, K))

        def ag(x):
            y, link = coll.zebra_all_gather(x, "model", bs=BS, bc=BC, tiled=True)
            return y[None], dev(link.moved), dev(link.dense)
        y, mv, dn = sm(ag, (rows,), (P(ALL), P(ALL), P(ALL)))(X)
        out[f"ag_{tag}_y"], out[f"ag_{tag}_moved"], out[f"ag_{tag}_dense"] = y, mv, dn

    for kind in PSUM_CASES:
        X = jnp.asarray(psum_shards(kind).reshape(4 * M, K))

        def ps(x):
            y, union, link = coll.zebra_psum_stream(x, "model", bs=BS, bc=BC)
            return y[None], union[None], dev(link.moved), dev(link.dense)
        y, un, mv, dn = sm(ps, (rows,), (P(ALL), P(ALL), P(ALL), P(ALL)))(X)
        out.update({f"ps_{kind}_y": y, f"ps_{kind}_union": un, f"ps_{kind}_moved": mv,
                    f"ps_{kind}_dense": dn})

        def rs(x):
            y, link = coll.zebra_reduce_scatter(x, "model", bs=BS, bc=BC)
            return y[None], dev(link.moved), dev(link.dense)
        y, mv, dn = sm(rs, (rows,), (P(ALL), P(ALL), P(ALL)))(X)
        out.update({f"rs_{kind}_y": y, f"rs_{kind}_moved": mv, f"rs_{kind}_dense": dn})

    def pe(b):
        hi, lo = coll.psum_exact_bytes(b[0], ALL)
        return hi, lo
    hi, lo = sm(pe, (P(ALL),), (P(), P()))(jnp.asarray(BYTES.astype(np.int32)))
    out["bytes_total"] = np.int64(int(hi) * 16777216 + int(lo))

    # the layer exchanges on the reduced gemma3-4b
    g3 = jconfigs.reduced("gemma3-4b")
    Y, Kv, Vv = exchange_inputs(g3.d_model, g3.n_kv_heads, g3.head_dim)
    seq = P(None, "model", None)
    for backend in ("stream", "reference"):
        cfg = g3.replace(zebra_backend=backend, zebra_sites=("ffn_hidden", "layer_out"),
                         zebra_t_obj=T_LAYER_OUT, zebra_tnet=False)

        def ffn_ex(y, cfg=cfg, backend=backend):
            with comm_context("model", 4):
                yf, sa = ffn_layer_out_exchange(y, cfg, "infer")
            labels[f"ffn_{backend}"] = sa.backend
            return (yf[None], dev(sa.ici_bytes), dev(sa.ici_dense_bytes),
                    dev(sa.measured_bytes), dev(sa.zero_frac))
        res = sm(ffn_ex, (seq,), (P(ALL),) * 5)(jnp.asarray(Y))
        for name, v in zip(("y", "ici", "ici_dense", "measured", "zf"), res):
            out[f"ffn_{backend}_{name}"] = v
    zc_kv = ZebraConfig(enabled=True, t_obj=T_KV, mode="infer", backend="stream",
                        use_tnet=False)

    def kv_ex(k, v):
        with comm_context("model", 4):
            kf, vf, auxes = gather_kv_shards(k, v, zc_kv)
        labels["kv"] = auxes[0].backend
        return (kf[None], vf[None], *[dev(getattr(a, f)) for a in auxes
                          for f in ("ici_bytes", "ici_dense_bytes", "measured_bytes",
                                    "zero_frac")])
    kvs = P(None, "model", None, None)
    res = sm(kv_ex, (kvs, kvs), (P(ALL),) * 10)(jnp.asarray(Kv), jnp.asarray(Vv))
    out["kv_k"], out["kv_v"] = res[0], res[1]
    for i, (t, f) in enumerate((t, f) for t in "kv" for f in
                               ("ici", "ici_dense", "measured", "zf")):
        out[f"kv_{t}_{f}"] = res[2 + i]

    # the data-parallel MoE on the reduced granite
    gr = jconfigs.reduced("granite-moe-1b-a400m").replace(
        zebra_tnet=False, zebra_t_obj=MOE_T_OBJ, zebra_backend="stream")
    p, x = moe_inputs(gr.d_model, gr.d_ff, gr.n_experts)
    y, la = jax.jit(lambda p_, x_: moe_apply_dp(p_, x_, gr, "infer", mesh, ALL))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    out.update(moe_y=y, moe_reg=la.reg, moe_zf_blocks=la.zf_blocks,
               moe_n_blocks=la.n_blocks, moe_router_aux=la.router_aux,
               moe_bytes=np.int64(la.measured_bytes_exact()))

    # the three ring faults of BENCH_faults.json
    X = jnp.asarray(fault_shards().reshape(4 * BM, BK))
    for name, coll_name, level, site, arg in FAULTS:
        def f(x, coll_name=coll_name, level=level, site=site):
            if coll_name == "all_gather":
                y, link = coll.zebra_all_gather(x, "model", bs=BS, bc=BC, tiled=True,
                                                validation=level, site=site)
                return y[None], dev(link.moved)
            y, _, link = coll.zebra_psum_stream(x, "model", bs=BS, bc=BC,
                                                validation=level, site=site)
            return y[None], dev(link.moved)
        integrity.clear_failures()
        with inject(Fault(kind="drop_hop", site=f"ring:{site}", arg=arg)) as plan:
            y, mv = sm(f, (rows,), (P(ALL), P(ALL)))(X)
            jax.block_until_ready(y)
        out.update({f"fault_{name}_y": y, f"fault_{name}_moved": mv,
                    f"fault_{name}_injected": np.int64(len(plan.injected)),
                    f"fault_{name}_detected": np.int64(len(integrity.failures()))})

    out = {k: np.asarray(v) for k, v in out.items()}
    out["labels"] = np.asarray(repr(labels))
    np.savez(path, **out)


# ---------------------------------------------------------------------------
# The port: one rank of an 8-rank gloo world on the CPU
# ---------------------------------------------------------------------------

def port_rank(rank: int, outdir: str) -> None:
    import torch

    from repro_torch import configs
    from repro_torch.compress import integrity
    from repro_torch.core.zebra import ZebraConfig
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.ctx import axis_of, comm_context, sharding_hints
    from repro_torch.ft import Fault, inject
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM
    from repro_torch.models.lm.attention import gather_kv_shards
    from repro_torch.models.lm.ffn import (FFN, MoE, ffn_apply, ffn_layer_out_exchange,
                                           moe_apply_dp)

    torch.set_num_threads(1)
    mesh = make_host_mesh(data=2, model=4, device="cpu")
    model, data = axis_of(mesh, "model"), axis_of(mesh, "data")
    wire = coll.Wire(model)
    t = torch.from_numpy
    out = {"model_index": model.index, "data_index": data.index,
           "wire": coll.wire_name(model.group)}

    for tag, zf, dead in AG_CASES:
        x = t(ag_shards(zf, dead)[model.index])
        coll.PAYLOAD_BYTES.update(sent=0, received=0)
        y, link = coll.zebra_all_gather(x, model, bs=BS, bc=BC, tiled=True)
        out.update({f"ag_{tag}_y": y, f"ag_{tag}_moved": int(link.moved),
                    f"ag_{tag}_dense": int(link.dense),
                    f"ag_{tag}_received": coll.PAYLOAD_BYTES["received"],
                    f"ag_{tag}_sent": coll.PAYLOAD_BYTES["sent"],
                    f"ag_{tag}_dense_gather": wire.all_gather(x).reshape(4 * M, K)})

    for kind in PSUM_CASES:
        x = t(psum_shards(kind)[model.index])
        y, union, link = coll.zebra_psum_stream(x, model, bs=BS, bc=BC)
        out.update({f"ps_{kind}_y": y, f"ps_{kind}_union": union,
                    f"ps_{kind}_moved": int(link.moved), f"ps_{kind}_dense": int(link.dense),
                    f"ps_{kind}_all_reduce": wire.all_reduce(x)})
        y, link = coll.zebra_reduce_scatter(x, model, bs=BS, bc=BC)
        out.update({f"rs_{kind}_y": y, f"rs_{kind}_moved": int(link.moved),
                    f"rs_{kind}_dense": int(link.dense),
                    f"rs_{kind}_dense_rs": wire.reduce_scatter(x)})

    world = coll.CommAxis("world", 8, torch.distributed.group.WORLD, rank)
    out["bytes_total"] = int(coll.psum_exact_bytes(int(BYTES[rank]), world))

    # the layer exchanges on the reduced gemma3-4b
    g3 = configs.reduced("gemma3-4b")
    Y, Kv, Vv = exchange_inputs(g3.d_model, g3.n_kv_heads, g3.head_dim)
    mine = slice(model.index * EX_S, (model.index + 1) * EX_S)
    for backend in ("stream", "reference"):
        cfg = g3.replace(zebra_backend=backend, zebra_sites=("ffn_hidden", "layer_out"),
                         zebra_t_obj=T_LAYER_OUT, zebra_tnet=False)
        with comm_context("model", mesh=mesh):
            yf, sa = ffn_layer_out_exchange(t(Y[:, mine].copy()), cfg, "infer")
        out.update({f"ffn_{backend}_y": yf, f"ffn_{backend}_label": sa.backend,
                    f"ffn_{backend}_ici": int(sa.ici_bytes),
                    f"ffn_{backend}_ici_dense": int(sa.ici_dense_bytes),
                    f"ffn_{backend}_measured": int(sa.measured_bytes),
                    f"ffn_{backend}_zf": sa.zero_frac})
    zc_kv = ZebraConfig(enabled=True, t_obj=T_KV, mode="infer", backend="stream",
                        use_tnet=False)
    with comm_context("model", mesh=mesh):
        kf, vf, auxes = gather_kv_shards(t(Kv[:, mine].copy()), t(Vv[:, mine].copy()), zc_kv)
    out.update(kv_k=kf, kv_v=vf, kv_label=auxes[0].backend)
    for name, a in zip("kv", auxes):
        out.update({f"kv_{name}_ici": int(a.ici_bytes),
                    f"kv_{name}_ici_dense": int(a.ici_dense_bytes),
                    f"kv_{name}_measured": int(a.measured_bytes), f"kv_{name}_zf": a.zero_frac})
    # ffn_apply under the context: the hidden site, then the exchange
    cfg = g3.replace(zebra_backend="stream", zebra_sites=("ffn_hidden", "layer_out"),
                     zebra_t_obj=T_LAYER_OUT, zebra_tnet=False)
    ffn = FFN(cfg, generator=torch.Generator().manual_seed(0))
    xin = t(Y[:, mine].copy())
    with torch.no_grad():
        y_local, hidden = ffn_apply(ffn, xin, cfg, "infer")
        with comm_context("model", mesh=mesh):
            y_full, merged = ffn_apply(ffn, xin, cfg, "infer")
            y_ex, ex = ffn_layer_out_exchange(y_local, cfg, "infer")
    out.update(ffn_apply_equal=bool(torch.equal(y_full, y_ex)),
               ffn_apply_shape=tuple(y_full.shape), ffn_apply_label=merged.backend,
               ffn_apply_bytes=int(merged.measured_bytes),
               ffn_apply_bytes_want=int(hidden.measured_bytes) + int(ex.measured_bytes),
               ffn_apply_ici=int(merged.ici_bytes), ffn_apply_ici_want=int(ex.ici_bytes))

    # the data-parallel MoE on the reduced granite
    gr = configs.reduced("granite-moe-1b-a400m").replace(
        zebra_tnet=False, zebra_t_obj=MOE_T_OBJ, zebra_backend="stream")
    p, x = moe_inputs(gr.d_model, gr.d_ff, gr.n_experts)
    moe = MoE(gr)
    moe.load_state_dict({k: t(v) for k, v in p.items()})
    with torch.no_grad():
        y, la = moe_apply_dp(moe, t(x[rank:rank + 1].copy()), gr, "infer", mesh,
                             ("data", "model"))
    out.update(moe_y=y[0], moe_reg=la.reg, moe_zf_blocks=la.zf_blocks,
               moe_n_blocks=la.n_blocks, moe_router_aux=la.router_aux,
               moe_bytes=la.measured_bytes_exact())
    # and through the model: the "dp" profile under sharding_hints against
    # a single-process forward of this rank's row
    lcfg = gr.replace(sharding_profile="dp")
    lm = LM(lcfg, generator=torch.Generator().manual_seed(0)).requires_grad_(False)
    tokens = t(np.random.default_rng(13).integers(0, lcfg.vocab, size=(8, MOE_S)))
    row = tokens[rank:rank + 1]
    with torch.no_grad():
        with sharding_hints(mesh, dp=("data", "model")):
            logits_dp, aux_dp = lm(row, "infer")
        logits_1, aux_1 = lm(row, "infer")
    out.update(lm_logits_equal=bool(torch.equal(logits_dp, logits_1)),
               lm_bytes_dp=aux_dp.measured_bytes_exact(),
               lm_bytes_1=aux_1.measured_bytes_exact(),
               lm_zf_blocks_dp=aux_dp.zf_blocks, lm_zf_blocks_1=aux_1.zf_blocks)

    # the three ring faults, and a clean run at each level
    x = t(fault_shards()[model.index])
    clean = {"all_gather": coll.zebra_all_gather(x, model, bs=BS, bc=BC, tiled=True)[0],
             "psum": coll.zebra_psum_stream(x, model, bs=BS, bc=BC)[0]}
    out["fault_dense_gather"] = wire.all_gather(x).reshape(4 * BM, BK)
    out["fault_dense_psum"] = wire.all_reduce(x)
    for name, coll_name, level, site, arg in FAULTS:
        run = (coll.zebra_all_gather if coll_name == "all_gather"
               else coll.zebra_psum_stream)
        integrity.clear_failures()
        res = run(x, model, bs=BS, bc=BC, validation=level, site=site,
                  **({"tiled": True} if coll_name == "all_gather" else {}))
        out[f"clean_{name}_detected"] = len(integrity.failures())
        out[f"clean_{name}_equal"] = bool(torch.equal(res[0], clean[coll_name]))
        integrity.clear_failures()
        with inject(Fault(kind="drop_hop", site=f"ring:{site}", arg=arg)) as plan:
            res = run(x, model, bs=BS, bc=BC, validation=level, site=site,
                      **({"tiled": True} if coll_name == "all_gather" else {}))
        out.update({f"fault_{name}_y": res[0], f"fault_{name}_moved": int(res[-1].moved),
                    f"fault_{name}_injected": len(plan.injected),
                    f"fault_{name}_detected": len(integrity.failures())})

    # BENCH_collectives.json's byte rows: totals over each axis's links
    for axis_name, axis in (("model", model), ("data", data)):
        x = t(bench_shards(axis_name)[axis.index])
        ag, l_ag = coll.zebra_all_gather(x, axis, bs=BS, bc=BC, tiled=True)
        ps, _, l_ps = coll.zebra_psum_stream(x, axis, bs=BS, bc=BC)
        rs, l_rs = coll.zebra_reduce_scatter(x, axis, bs=BS, bc=BC)
        w = coll.Wire(axis)
        for op, link in (("all_gather", l_ag), ("psum_stream", l_ps),
                         ("reduce_scatter", l_rs)):
            out[f"bench_{op}_{axis_name}"] = (
                int(coll.psum_exact_bytes(link.moved, axis)),
                int(coll.psum_exact_bytes(link.dense, axis)))
        out[f"bench_equal_{axis_name}"] = (
            bool(torch.equal(ag, w.all_gather(x).reshape(-1, BK))),
            bool(torch.equal(ps, w.all_reduce(x))),
            bool(torch.equal(rs, w.reduce_scatter(x))))
    torch.save(out, f"{outdir}/rank{rank}.pt")
