"""The configurations of ``tests/test_torch_tp_train_layers.py`` and the two
programs that train them: :func:`reference_main` (the reference's
``jax.jit(make_train_step)`` with ``train_state_specs`` on 8 forced host
devices at ``make_host_mesh(model=4)``, data 2; one JAX process a
configuration) and :func:`port_rank` (one rank of the port's 8-rank
``gloo`` world on the CPU, a (data 2, model 4) mesh, rank = data index * 4
+ model index, that trains every configuration in turn with
``launch.steps.train_step`` on a model cut for training).

The configurations are the reduced MoE, Mamba-2, RG-LRU and
encoder-decoder architectures in float32, each of which fails one likely
fault of the sharded backward: granite on ``stream`` at K 2 with bf16
compression (the expert-parallel dispatch: the global rows' gradient
summed over ``data``, the experts' input summed over ``model``); granite
at capacity factor 0.5, where pairs drop; granite on ``reference`` with
threshold nets (the dispatch map gathered by rows for its net); llama4
(one expert a rank) with int8 compression; mamba2 with every norm scale
and the SSD's ``A_log``/``D``/``dt_bias`` drawn (the gated RMSNorm's sum
and the B/C inputs of the split SSD); recurrentgemma (the RG-LRU's gate
input), also at 6 heads (the local attention replicated beside the split
RG-LRU); whisper on numpy frames at ``enc_seq`` 64, a multiple of
``block_seq``, so its encoder's sites run the kernel path; and granite
under the "dp" sharding profile (every rank routes its own rows, the
aux's mean over the ranks carries the router's gradient).

The reference draws its train state from key 0, replaces every bias,
norm scale and the SSD's and RG-LRU's constants by numpy draws
(``_torch_tp_layers_cases.draw_extras``) and writes the parameters (as
the port's dotted names) before it compiles anything; the port's ranks
wait for that file. Both take two steps at ``warmup_cosine(1e-3, 1, 10)``
on the same 8 x 64-token batch (and frames), each rank its rows of every
microbatch (``steps.data_rows`` of ``steps.batch_shards``). This module
imports numpy only at the top: the port's ranks import it without JAX.
"""
from __future__ import annotations

import os

import numpy as np

import _torch_tp_train_cases as TC
from _torch_tp_cases import _wait
from _torch_tp_layers_cases import draw_extras

B, S, STEPS, LR, SEED = TC.B, TC.S, TC.STEPS, TC.LR, TC.SEED
MODEL, DATA = TC.MODEL, TC.DATA
COMMON = dict(param_dtype="float32", compute_dtype="float32", ce_chunk=64)
GRANITE = "granite-moe-1b-a400m"
# tag: (architecture, fields replaced, backend, T_obj, sites, threshold
# nets, gradient compression)
CASES = {
    "granite": (GRANITE, dict(grad_accum=2), "stream", 0.025, ("ffn_hidden",), False,
                "bf16"),
    "granite_drop": (GRANITE, dict(capacity_factor=0.5), "pallas", 0.025, ("ffn_hidden",),
                     False, "none"),
    "granite_tnet": (GRANITE, {}, "reference", 0.025, ("ffn_hidden",), True, "none"),
    "llama4": ("llama4-scout-17b-a16e", {}, "stream", 0.025, ("ffn_hidden",), False,
               "int8"),
    "mamba2": ("mamba2-2.7b", {}, "stream", 4.8, ("layer_out",), False, "none"),
    "rgemma": ("recurrentgemma-2b", {}, "pallas", 2.5, ("ffn_hidden",), False, "none"),
    "rgemma_6h": ("recurrentgemma-2b", dict(n_heads=6), "stream", 2.5, ("ffn_hidden",), False,
                  "none"),
    "whisper": ("whisper-medium", dict(enc_seq=64), "stream", 2.5, ("ffn_hidden",), False,
                "none"),
    "granite_dp": (GRANITE, dict(sharding_profile="dp"), "stream", 0.025, ("ffn_hidden",),
                   False, "none"),
}
METRICS = ("loss", "ce", "grad_norm", "zero_frac", "zebra_reg", "router_aux")


def config(case: str, pkg):
    arch, fields, backend, t_obj, sites, tnet, _ = CASES[case]
    return pkg.reduced(arch).replace(**COMMON, **fields, zebra_backend=backend,
                                     zebra_t_obj=t_obj, zebra_sites=sites, zebra_tnet=tnet)


def compress_mode(case: str) -> str:
    return CASES[case][6]


def frames(cfg) -> np.ndarray | None:
    """whisper's frames (B, enc_seq, d) ~ N(0, 1) from numpy; None for a
    decoder-only architecture."""
    if not cfg.encoder_layers:
        return None
    rng = np.random.default_rng(7)
    return rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def reference_main(out_dir: str, case: str) -> None:
    """Configuration ``case``: the initial parameters (written first), then
    two jitted sharded steps; saves each step's metrics, the first AdamW
    moment after step 1 and the parameters after step 2, whole, by the
    port's names."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import configs, optim
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import make_train_state_shape, make_train_step, train_state_specs
    from repro.models.lm import LM
    from repro_torch import configs as tconfigs
    from repro_torch.models.lm import LM as TLM
    from repro_torch.models.lm.convert import port_params

    cfg = config(case, configs)
    tmodel = TLM(config(case, tconfigs), device="meta")
    names = lambda tree: port_params(tmodel, jax.tree_util.tree_map(np.asarray, tree))
    model = LM(cfg)
    opt = optim.adamw(optim.warmup_cosine(*LR))
    mode = compress_mode(case)
    shape, init_fn = make_train_state_shape(model, opt, mode)
    state = jax.jit(init_fn)(jax.random.PRNGKey(SEED))
    state = dict(state, params=draw_extras(state["params"]))
    tmp = f"{out_dir}/params_{case}.tmp.npz"
    np.savez(tmp, **names(state["params"]))
    os.replace(tmp, f"{out_dir}/params_{case}.npz")
    mesh = make_host_mesh(model=MODEL)
    sshard = jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s),
                                    train_state_specs(shape, cfg, mesh),
                                    is_leaf=lambda x: isinstance(x, P))
    batch = {"tokens": jnp.asarray(TC.tokens())}
    bshard = {"tokens": NamedSharding(mesh, shd.batch_spec(mesh, 2, cfg=cfg))}
    enc = frames(cfg)
    if enc is not None:
        batch["enc_feats"] = jnp.asarray(enc)
        bshard["enc_feats"] = NamedSharding(mesh, shd.batch_spec(mesh, 3, cfg=cfg))
    step = jax.jit(make_train_step(model, opt, mesh, mode), in_shardings=(sshard, bshard),
                   out_shardings=(sshard, None))
    state = jax.device_put(state, sshard)
    out = {}
    for i in range(STEPS):
        state, m = step(state, batch)
        for k in METRICS:
            out[f"m{i}_{k}"] = np.asarray(m[k])
        out[f"m{i}_bytes"] = np.asarray(int(float(m["measured_bytes_hi"])) * 2 ** 24
                                        + int(float(m["measured_bytes_lo"])))
        if i == 0:
            out.update({f"mom.{k}": v for k, v in names(state["opt"]["m"]).items()})
    out.update({f"param.{k}": v for k, v in names(state["params"]).items()})
    np.savez(f"{out_dir}/ref_{case}.npz", **out)


def port_rank(rank: int, out_dir: str) -> None:
    """One rank: every configuration trained two sharded steps from the
    reference's parameters. Saves ``rank<r>.pt``: per configuration each
    step's metrics, the first moment's shards after step 1, the master
    parameters' shards and the module's (gathered) parameters after step
    2, the placements, the tensor-parallel backward's collectives, every
    MoE dispatch's tokens, capacity and dropped pairs, and with
    compression each step's gradient shards as ``level_position``s
    (``_edge``)."""
    import torch

    from repro_torch import configs, optim
    from repro_torch.distributed.collectives import TP_TRAFFIC
    from repro_torch.distributed.sharding import shard_model_
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM, ffn

    routes: list = []                   # (tokens routed, capacity, pairs dropped)
    route = ffn.moe_route

    def recorded(router, xt, cfg):
        r = route(router, xt, cfg)
        if torch._C._current_graph_task_id() == -1:     # not a remat recompute
            routes.append((xt.shape[0], r.cap, int((r.dest == cfg.n_experts * r.cap).sum())))
        return r
    ffn.moe_route = recorded
    torch.set_num_threads(1)            # 8 ranks share the host's cores
    mesh = make_host_mesh(model=MODEL, device="cpu")
    di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    res = {"data_index": di, "model_index": mi}
    for case in CASES:
        path = f"{out_dir}/params_{case}.npz"
        _wait(path)
        flat = dict(np.load(path))
        cfg = config(case, configs)
        model = LM(cfg)
        with torch.no_grad():
            for name, t in model.state_dict().items():
                t.copy_(torch.from_numpy(flat[name]))
        shard_model_(model, mesh, train=True)
        opt = optim.adamw(optim.warmup_cosine(*LR))
        mode = compress_mode(case)
        state = steps.init_train_state(model, opt, mode)
        rows = steps.data_rows(B, cfg.grad_accum, *steps.batch_shards(cfg, DATA, MODEL, di, mi))
        batch = {"tokens": torch.from_numpy(TC.tokens()[rows]).long()}
        enc = frames(cfg)
        if enc is not None:
            batch["enc_feats"] = torch.from_numpy(enc[rows])
        bwd = TP_TRAFFIC["bwd_calls"]
        routes.clear()
        res[f"{case}_edge"] = []
        for i in range(STEPS):
            with TC.wire_positions(steps, res[f"{case}_edge"]):
                state, m = steps.train_step(model, opt, state, batch, compress=mode,
                                            check_finite=True)
            res[f"{case}_m{i}"] = {**{k: m[k].clone() for k in METRICS},
                                   "bytes": int(m["measured_bytes"])}
            if i == 0:
                res[f"{case}_mom"] = {k: v.clone() for k, v in state["opt"]["m"].items()}
        steps.gather_params_(model, state)
        res[f"{case}_params"] = {k: v.detach().clone() for k, v in state["params"].items()}
        res[f"{case}_module"] = {k: v.detach().clone() for k, v in model.named_parameters()}
        res[f"{case}_places"] = model.train_places
        res[f"{case}_bwd_calls"] = TP_TRAFFIC["bwd_calls"] - bwd
        res[f"{case}_routes"] = list(routes)
        res[f"{case}_rows"] = rows
    torch.save(res, f"{out_dir}/rank{rank}.pt")
