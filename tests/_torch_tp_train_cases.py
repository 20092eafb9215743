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

Configuration ``CKPT_CASE`` then checkpoints its sharded state after the
last step on both sides (:func:`reference_ckpt`, :func:`port_ckpt`): the
reference's ``CheckpointManager`` of its state, the port's 8 ranks'
``ShardedCheckpointManager``, restored at three layouts of the same
world, a crash and resume under the supervisor, and ``remesh_state``.
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
CKPT_CASE = "a"                 # int8: its residual is a checkpointed leaf
LAYOUTS = (MODEL, 2, 1)         # the model axes a checkpoint restores at: data 2, 4, 8
RUN_STEPS, CKPT_EVERY, CRASH_AT = 4, 2, 3
REMESH_MODELS = (1, 2, 3, 4, 5, 6, 8, 16, 32)   # stand-in old meshes' model axes


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
    if case == CKPT_CASE:
        out.update(reference_ckpt(out_dir, state))
    np.savez(f"{out_dir}/ref_{case}.npz", **out)


def reference_ckpt(out_dir: str, state) -> dict:
    """The reference's checkpoint of its sharded state after the last
    step, ``CheckpointManager.save`` (every leaf whole, ``jax.device_get``)
    with the loader's step, under ``<out_dir>/ref_ckpt``; whether its
    ``restore(like=state)`` gives every leaf, the step and the extra back
    bit for bit; and the model axis its ``remesh_state`` keeps on these 8
    devices for a stand-in old mesh of each of ``REMESH_MODELS`` (it reads
    only ``old_mesh.shape``)."""
    import types

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.checkpoint.manager import CheckpointManager
    from repro.ft import remesh_state
    mgr = CheckpointManager(f"{out_dir}/ref_ckpt", async_save=False)
    mgr.save(STEPS, state, {"loader_step": STEPS})
    step, tree, extra = mgr.restore(state)
    want = jax.tree_util.tree_leaves(jax.device_get(state))
    got = jax.tree_util.tree_leaves(tree)
    same = (step == STEPS and extra == {"loader_step": STEPS} and len(got) == len(want)
            and all(np.asarray(a).dtype == np.asarray(b).dtype
                    and np.asarray(a).tobytes() == np.asarray(b).tobytes()
                    for a, b in zip(got, want)))
    kept = []
    for m in REMESH_MODELS:
        _, mesh = remesh_state({"w": jnp.ones((8, 4))}, None,
                               types.SimpleNamespace(shape={"model": m}),
                               lambda s, c, mesh: jax.tree_util.tree_map(lambda _: P(), s))
        kept.append((m, mesh.shape["model"]))
    return {"ckpt_restore_same": np.asarray(same), "remesh_kept": np.asarray(kept)}


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
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)            # 8 ranks share the host's cores
    mesh = make_host_mesh(model=MODEL, device="cpu")
    di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    res = {"data_index": di, "model_index": mi}
    for case in CASES:
        cfg = config(case, configs)
        model = reference_model(out_dir, case, mesh)
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
        if case == CKPT_CASE:
            res["ckpt"] = port_ckpt(out_dir, case, model, state)
    torch.save(res, f"{out_dir}/rank{rank}.pt")


def reference_model(out_dir: str, case: str, mesh):
    """The port's model of ``case`` holding the reference's initial
    parameters, cut for training on ``mesh``."""
    import torch

    from repro_torch import configs
    from repro_torch.distributed.sharding import shard_model_
    from repro_torch.models.lm import LM
    path = f"{out_dir}/params_{case}.npz"
    TPC._wait(path)
    flat = dict(np.load(path))
    model = LM(config(case, configs))
    with torch.no_grad():
        for name, t in model.state_dict().items():
            t.copy_(torch.from_numpy(flat[name]))
    return shard_model_(model, mesh, train=True)


def snapshot(model, state) -> dict:
    """This rank's train state (every flat leaf: tensors cloned, the step)
    and its module's tensors, with the placements and its coordinates on
    the model's mesh."""
    import torch

    from repro_torch.checkpoint.manager import _leaves
    from repro_torch.distributed.sharding import mesh_shape
    return {"state": {k: v.detach().clone() if torch.is_tensor(v) else v
                      for k, v in _leaves(state)},
            "module": {k: v.detach().clone() for k, v in model.named_parameters()},
            "places": dict(model.train_places), "shape": mesh_shape(model.mesh),
            "coords": {a: model.mesh.get_local_rank(a) for a in ("data", "model")}}


def tensors(state) -> list:
    """Every tensor leaf of a train state."""
    import torch

    from repro_torch.checkpoint.manager import _leaves
    return [v for _, v in _leaves(state) if isinstance(v, torch.Tensor)]


def port_ckpt(out_dir: str, case: str, model, state) -> dict:
    """The port's checkpoint of ``case``'s sharded state after the last
    step, in the world of 8: the save (``<out_dir>/ckpt``, rank 0
    writing); its restore into a fresh model and state at each of
    ``LAYOUTS`` (the same mesh, then (data 4, model 2) and (data 8, model
    1)), the restored state at (4, 2) saved again (``<out_dir>/ckpt_m2``);
    the supervisor's decision to resume where only rank 0 sees the file
    (every other rank a directory of its own; ``unshared``: what each
    rank raised, or None); a crash and resume under ``launch.train.train_lm``
    (``RUN_STEPS`` steps, a checkpoint every ``CKPT_EVERY``,
    ``ft.crashing_step`` at call ``CRASH_AT`` on every rank, moving every
    parameter, both moments and the residual before it raises)
    beside the same run uninterrupted, both from the reference's initial
    parameters; and ``ft.remesh_state`` of the resumed state on this
    world. Returns the snapshots (:func:`snapshot`), histories and logs."""
    import torch

    from repro_torch import configs, ft, optim
    from repro_torch.checkpoint.sharded import ShardedCheckpointManager
    from repro_torch.distributed.sharding import shard_model_, train_state_specs
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM
    cfg, mode, mesh = config(case, configs), compress_mode(case), model.mesh
    out = {"dir": out_dir, "saved": snapshot(model, state)}
    saver = ShardedCheckpointManager(f"{out_dir}/ckpt", model)
    saver.save(STEPS, state, {"loader_step": STEPS})
    saver.wait()
    rank = torch.distributed.get_rank()
    alone = ft.StepSupervisor(ft.FTConfig(
        ckpt_dir=f"{out_dir}/ckpt" if rank == 0 else f"{out_dir}/alone{rank}"), model=model)
    try:
        alone.resume_or_init(lambda: state, like=state)
        out["unshared"] = None
    except RuntimeError as e:
        out["unshared"] = str(e)
    for m in LAYOUTS:
        fresh = shard_model_(LM(cfg), mesh if m == MODEL else make_host_mesh(model=m,
                                                                              device="cpu"),
                             train=True)
        st = steps.init_train_state(fresh, optim.adamw(optim.warmup_cosine(*LR)), mode)
        step, st, extra = ShardedCheckpointManager(f"{out_dir}/ckpt", fresh).restore(st)
        out[f"restored_{m}"] = dict(snapshot(fresh, st), step=step, extra=extra)
        if m == 2:
            again = ShardedCheckpointManager(f"{out_dir}/ckpt_m2", fresh)
            again.save(step, st, extra)
            again.wait()
    di = mesh.get_local_rank("data")
    inner = train.train_step

    def run(ckpt, crash: bool):
        fresh = reference_model(out_dir, case, mesh)
        seen = {}

        def recording(model, opt, state, *a, **kw):
            seen.update(model=model, state=state)
            return inner(model, opt, state, *a, **kw)

        def dirty():
            """The crash after a half-applied update: every parameter, both
            moments and the residual moved."""
            with torch.no_grad():
                for t in (*seen["model"].parameters(), *tensors(seen["state"])):
                    t.add_(1.0)
            return ft.TransientStep(f"injected crash at call {CRASH_AT}")
        if crash:
            train.train_step = ft.crashing_step(recording, CRASH_AT, exc=dirty)
        try:
            _, st, hist, sup = train.train_lm(
                cfg, steps=RUN_STEPS, batch=B, seq=S, lr=LR[0], compress=mode, seed=SEED,
                device="cpu", model=fresh, log=lambda *_: None, ckpt=ckpt,
                ckpt_every=CKPT_EVERY, rows=steps.data_rows(B, cfg.grad_accum, DATA, di))
        finally:
            train.train_step = inner
        steps.gather_params_(fresh, st)         # the module holds the trained weights
        return {"end": snapshot(fresh, st), "history": hist,
                "failures": [e["class"] for e in sup.failure_log]}, fresh, st
    out["uninterrupted"], _, _ = run(None, False)
    out["resumed"], fresh, st = run(f"{out_dir}/ckpt_run", True)
    st, _ = ft.remesh_state(st, cfg, fresh.mesh, train_state_specs, model=fresh)
    out["remeshed"] = snapshot(fresh, st)
    return out
