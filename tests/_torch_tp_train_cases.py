"""The configurations of ``tests/test_torch_tp_train.py`` and the two
programs that train them: :func:`reference_main` (the reference's
``jax.jit(make_train_step)`` with ``train_state_specs`` on 8 forced host
devices at ``make_host_mesh(model=4)``, data 2; one JAX process a
configuration) and :func:`port_rank` (one rank of the port's 8-rank
``gloo`` world on the CPU, a (data 2, model 4) mesh, rank = data index * 4
+ model index, running ``launch.steps.train_step`` on a model cut for
training).

The reference draws its train state from key 0, every bias drawn anew
(``_torch_tp_cases.draw_biases``), and writes the parameters (as the
port's dotted names) before it compiles anything; the port's ranks wait
for that file, build the model whole, load the values and cut their
training shards (``distributed.sharding.shard_model_(..., train=True)``),
then ``init_train_state`` cuts the state over ``data``. Both take two
steps at ``warmup_cosine(1e-3, 1, 10)`` (the first step's lr is 0, the
second moves the parameters) on the same 8 x 64-token batch, each data
rank its rows of every microbatch (``steps.data_rows``). This module
imports numpy only at the top: the port's ranks import it without JAX.
"""
from __future__ import annotations

import os

import numpy as np

import _torch_tp_cases as TPC

B, S = 8, 64
MODEL, DATA = TPC.MODEL, TPC.DATA
STEPS = 2
LR = (1e-3, 1, 10)
SEED = 0
COMMON = dict(param_dtype="float32", compute_dtype="float32", ce_chunk=64,
              zebra_sites=("ffn_hidden",))
# (a) the reduced gemma3-4b on stream at a constant threshold, K 2, int8:
# its d_ff shard (64 a rank) cuts the 8x128 blocks, so the site gathers its
# map, and its 2 KV heads replicate over 4 model ranks; (b) the widened
# starcoder2-15b (every map on block edges; GELU and QKV biases across the
# sums) on stream, K 1, bf16; (c) the reduced gemma3-4b on reference with
# threshold nets, K 1, no compression
CASES = {
    "a": ("gemma3", dict(zebra_backend="stream", zebra_tnet=False, zebra_t_obj=2.45,
                         grad_accum=2), "int8"),
    "b": ("starcoder2", dict(zebra_backend="stream", zebra_tnet=False, zebra_t_obj=2.3),
          "bf16"),
    "c": ("gemma3", dict(zebra_backend="reference", zebra_tnet=True, zebra_t_obj=2.45),
          "none"),
}
METRICS = ("loss", "ce", "grad_norm", "zero_frac", "zebra_reg")


def config(case: str, pkg):
    tag, kw, _ = CASES[case]
    arch, widen = TPC.CONFIGS[tag]
    return pkg.reduced(arch).replace(**COMMON, **widen, **kw)


def compress_mode(case: str) -> str:
    return CASES[case][2]


def tokens() -> np.ndarray:
    from repro_torch.data import LMDatasetConfig, lm_batch
    return lm_batch(LMDatasetConfig(vocab=512), B, S, 0)


def flat_specs(tree, prefix: str = "") -> dict:
    """{dotted path: spec} of a tree of dicts and named tuples whose leaves
    are partition specs (tuples); a None subtree is skipped."""
    out = {}
    items = tree._asdict().items() if hasattr(tree, "_asdict") else tree.items()
    for k, v in items:
        if v is None:
            continue
        if isinstance(v, dict) or hasattr(v, "_asdict"):
            out.update(flat_specs(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tuple(v)
    return out


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
    state = dict(state, params=TPC.draw_biases(state["params"]))
    tmp = f"{out_dir}/params_{case}.tmp.npz"
    np.savez(tmp, **names(state["params"]))
    os.replace(tmp, f"{out_dir}/params_{case}.npz")
    mesh = make_host_mesh(model=MODEL)
    sshard = jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s),
                                    train_state_specs(shape, cfg, mesh),
                                    is_leaf=lambda x: isinstance(x, P))
    bshard = {"tokens": NamedSharding(mesh, shd.batch_spec(mesh, 2))}
    step = jax.jit(make_train_step(model, opt, mesh, mode), in_shardings=(sshard, bshard),
                   out_shardings=(sshard, None))
    state = jax.device_put(state, sshard)
    batch = {"tokens": jnp.asarray(tokens())}
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


def level_position(mode: str, x):
    """Where each element of a float32 tensor ``x`` lies between two levels
    of its wire format, in [0, 1) of the level's width: 0.5 is the
    rounding boundary. bf16 (``x`` the gradient): the low 16 bits of the
    float32 pattern over 2**16 (bf16 keeps the high 16, rounded to nearest
    at 0x8000); int8 (``x`` the quotient ``(g + e) / scale``): its
    fractional part."""
    import torch
    if mode == "bf16":
        return (x.view(torch.int32) & 0xFFFF).double() / 2 ** 16
    return x.double() - x.double().floor()


class wire_positions:
    """Around one ``steps.train_step``: appends {name: ``level_position``
    of each element of this rank's reduced gradient as it enters the wire
    format} to ``out`` (nothing for ``none``). int8's quotient is taken
    with the scale the step uses (the max over every shard)."""

    def __init__(self, steps, out: list):
        self.steps, self.out = steps, out

    def __enter__(self):
        import torch
        inner = self.inner = self.steps.compressed_gradients

        def capture(grads, cstate, mode="bf16", *, global_max=None):
            if mode == "bf16":
                self.out.append({k: level_position(mode, g) for k, g in grads.items()})
            if mode != "int8":
                return inner(grads, cstate, mode, global_max=global_max)
            ge = {k: cstate.error[k] + g for k, g in grads.items()}
            amax = {}

            def gm(a):
                amax.update(global_max(a) if global_max is not None else a)
                return amax
            out = inner(grads, cstate, mode, global_max=gm)
            self.out.append({k: level_position(mode, torch.div(
                v, torch.clamp(amax[k], min=1e-12) / 127.0)) for k, v in ge.items()})
            return out
        self.steps.compressed_gradients = capture
        return self

    def __exit__(self, *exc):
        self.steps.compressed_gradients = self.inner


def port_rank(rank: int, out_dir: str) -> None:
    """One rank: every configuration trained two sharded steps from the
    reference's parameters. Saves ``rank<r>.pt``: each step's metrics, the
    first moment's shards after step 1, the master parameters' shards and
    the module's (gathered) parameters after step 2, the placements, the
    tensor-parallel collectives of the backward, and with compression each
    step's gradient shards as ``level_position``s (``_edge``)."""
    import torch

    from repro_torch import configs, optim
    from repro_torch.distributed.collectives import TP_TRAFFIC
    from repro_torch.distributed.sharding import shard_model_
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM

    torch.set_num_threads(1)            # 8 ranks share the host's cores
    mesh = make_host_mesh(model=MODEL, device="cpu")
    di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    res = {"data_index": di, "model_index": mi}
    for case in CASES:
        path = f"{out_dir}/params_{case}.npz"
        TPC._wait(path)
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
        rows = steps.data_rows(B, cfg.grad_accum, DATA, di)
        batch = {"tokens": torch.from_numpy(tokens()[rows]).long()}
        bwd = TP_TRAFFIC["bwd_calls"]
        res[f"{case}_edge"] = []
        for i in range(STEPS):
            with wire_positions(steps, res[f"{case}_edge"]):
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
    torch.save(res, f"{out_dir}/rank{rank}.pt")
