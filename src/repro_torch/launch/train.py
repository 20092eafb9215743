"""LM training launcher (``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \\
        --layers 12 --batch 2 --seq 2048 --steps 3 --t-obj 1.05 --backend pallas

Builds the model (random weights from ``--seed``, float32 parameters,
bf16 compute, ``--remat`` or the config's), AdamW under ``warmup_cosine(--lr,
steps // 10, steps)`` and the counter-indexed token stream
(``data.lm_batch``), and runs ``launch.steps.train_step`` for ``--steps``
steps under ``ft.StepSupervisor``, logging as the reference does. It runs
on the card; ``--device cpu`` runs it on the CPU (the kernels' plain
versions). ``--layers N`` keeps the first N layers at full width. ``--arch`` takes
every ported architecture (``configs.ARCHS``: the dense ones, the MoE
ones, whose loss adds ``router_aux_coef · router_aux``, whisper-medium,
mamba2-2.7b and recurrentgemma-2b); the CLI feeds tokens only, as the reference's does, so
an encoder-decoder trains its decoder without cross-attention there, and
:func:`train_lm` takes a per-step source of encoder frames.
``--backend`` picks the Zebra site backend: with the default threshold
nets (Eq. 1) every site trains on ``reference``, as the capability rules
send a site with a net; :func:`train_lm` takes any config, e.g.
constant-threshold training (``zebra_tnet=False``) through the ``pallas``
or ``stream`` kernels.

``--ckpt DIR`` checkpoints the state and the loader's step every
``--ckpt-every`` steps and at the end, and resumes from the newest valid
checkpoint there: a crashed run restores and goes on (the supervisor's
restore-and-retry), and a run started again continues where the last one
stopped. Without ``--ckpt`` nothing is written (the reference defaults to a
directory under ``/tmp``, which every later run would resume from).

``--model-parallel N`` trains every ported architecture with the sharded
train step (:func:`train_tensor_parallel`): on a ``("data", "model")``
mesh, the layers tensor-parallel over ``model`` (attention heads and
d_ff, the MoE's experts, Mamba-2's SSD heads, the RG-LRU's channels, the
encoder-decoder's encoder and cross-attention) and the train state split
over ``data`` as well (FSDP), each data rank taking its rows of every
microbatch of the one global batch (under a config's "dp" sharding
profile every rank takes its own rows and no layer is tensor-parallel):

    PYTHONPATH=src python -m repro_torch.launch.train --model-parallel 4 \
        --reduced --device cpu --steps 2 --batch 8 --seq 64

From a plain shell it spawns N ranks on this host (data 1; on one card
they share it over ``gloo``); inside a joined world of a multiple of N
ranks each process trains as its rank (:func:`train_rank`), with data =
world / N. Experts or SSD heads that do not split over N and a batch that
does not split over its ranks × ``grad_accum`` raise before any rank
starts. The CLI feeds tokens only; :func:`train_rank` takes a source of
encoder frames as :func:`train_lm` does.

``--ckpt DIR`` under ``--model-parallel`` checkpoints the sharded state as
whole leaves, the one-process format (``checkpoint.sharded``): rank 0
gathers and writes them, every rank restores its shards of them. A run
started again resumes where the last one stopped, at the same layout or
at another ``--model-parallel`` in a world it divides:

    PYTHONPATH=src python -m repro_torch.launch.train --model-parallel 2 \
        --reduced --device cpu --steps 4 --ckpt DIR --ckpt-every 2
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from .. import configs
from ..data import LMDatasetConfig, StreamingLoader, lm_batch
from ..ft import FTConfig, StepSupervisor
from ..models.lm import LM, LMConfig
from ..models.lm.remat import REMATS
from ..optim import adamw, warmup_cosine
from ..utils import float32_sums, resolve_device
from .steps import batch_shards, data_rows, gather_params_, init_train_state, train_step

LOG_KEYS = ("loss", "ce", "zebra_reg", "zero_frac", "router_aux", "grad_norm",
            "measured_bytes")


def build_config(arch: str, *, reduced: bool = False, t_obj: float = 0.1,
                 backend: str = "reference", n_layers: int = 0) -> LMConfig:
    """The architecture's training config (its float32 parameters, bf16
    compute); ``n_layers`` > 0 keeps the first that many layers."""
    cfg = configs.with_layers(arch, reduced=reduced, n_layers=n_layers)
    return cfg.replace(zebra_t_obj=t_obj, zebra_backend=backend)


def _log(step: int, m: dict, log=print) -> None:
    if step % 10 == 0 or step <= 2:
        log(f"step {step:5d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
            f"zreg={m['zebra_reg']:.4f} zf={m['zero_frac']:.3f} "
            f"gnorm={m['grad_norm']:.2f}")


def train_lm(cfg: LMConfig, *, steps: int = 50, batch: int = 8, seq: int = 128,
             lr: float = 3e-4, compress: str = "bf16", seed: int = 0, device=None,
             model: LM | None = None, log=print, ckpt: str | None = None,
             ckpt_every: int = 25, enc_feats=None, rows: list[int] | None = None):
    """Train ``cfg`` for ``steps`` steps on ``batch`` x ``seq`` tokens of
    the synthetic stream (seed ``seed``), an encoder-decoder also on the
    frames ``enc_feats(step)`` (B, enc_seq, d) of each loader step when a
    source is given; ``model`` (else a new one, its
    weights drawn from a ``torch.Generator`` seeded ``seed`` on the
    device; the frames of the global batch, cut by ``rows`` as the tokens
    are) is trained in place, under a ``StepSupervisor`` that
    checkpoints to ``ckpt`` (None: no checkpoints) every ``ckpt_every``
    steps and resumes from it (a model cut for training: whole leaves,
    ``checkpoint.sharded``). Returns ``(model, state, history,
    supervisor)``: one history row per completed step, the metrics read
    on the host (one read a step, after the finite-loss check's) with
    ``step`` and ``ms``, the step's host-clock time. ``rows``: the rows of
    each global batch this process trains on (a data rank of a model cut
    for training: ``launch.steps.data_rows``)."""
    device = resolve_device(device)
    if device.type == "cuda":
        # full float32 for every float32 matmul, as the reference computes it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if model is None:
        model = LM(cfg, generator=torch.Generator(device=device).manual_seed(seed),
                   device=device)
    opt = adamw(warmup_cosine(lr, max(steps // 10, 1), steps))
    ds = LMDatasetConfig(vocab=cfg.vocab, seed=seed)
    def make_batch(b, s):
        toks = lm_batch(ds, b, seq, s)
        out = {"tokens": toks if rows is None else toks[rows]}
        if enc_feats is not None:
            frames = enc_feats(s)
            out["enc_feats"] = frames if rows is None else frames[rows]
        return out
    loader = StreamingLoader(make_batch, batch)
    sup = StepSupervisor(FTConfig(ckpt_dir=ckpt, ckpt_every=ckpt_every), model=model)
    state, start, extra = sup.resume_or_init(lambda: init_train_state(model, opt, compress))
    loader.restore(extra.get("loader_step", start))
    if start:
        log(f"[train] resumed at step {start} from {ckpt}")

    def step_fn(state, batch):
        inputs = {"tokens": torch.from_numpy(batch["tokens"]).to(device=device,
                                                                  dtype=torch.int64)}
        if "enc_feats" in batch:
            inputs["enc_feats"] = batch["enc_feats"].to(device)
        t0 = time.perf_counter()
        state, metrics = train_step(model, opt, state, inputs, compress=compress,
                                    check_finite=True)
        # one device-to-host copy; float64 holds every float32 metric and
        # the byte count (< 2**53) exactly
        vals = torch.stack([metrics[k].double() for k in LOG_KEYS]).tolist()
        return state, dict(zip(LOG_KEYS, vals), ms=(time.perf_counter() - t0) * 1e3)

    history = []

    def on_metrics(step, m):
        m = dict(m, step=step, measured_bytes=int(m["measured_bytes"]))
        history.append(m)
        _log(step, m, log)

    state, _ = sup.run(state, step_fn, loader, steps, start, loader_state_fn=loader.state,
                       on_metrics=on_metrics)
    return model, state, history, sup


def parse_args(argv=None) -> argparse.Namespace:
    """The CLI's arguments (what :func:`main` and :func:`train_rank` read)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--layers", type=int, default=0,
                    help="train only the first N layers at full width (0: the "
                         "architecture's depth)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory: save there and resume from it (default: "
                         "no checkpoints)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--compress", default="bf16", choices=["none", "bf16", "int8"])
    ap.add_argument("--remat", default=None, choices=list(REMATS),
                    help="what the backward keeps of a layer unit (default: the "
                         "config's, block)")
    ap.add_argument("--t-obj", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="reference",
                    choices=["reference", "pallas", "stream", "fused"],
                    help="Zebra site-engine backend for every activation site (sites "
                         "with threshold nets train on reference)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (no fallback); 'cpu' runs the "
                         "kernels' plain versions on the CPU")
    ap.add_argument("--save", default=None,
                    help="--model-parallel: each rank also saves its report (history, "
                         "times, memory, state bytes, collectives) to DIR/rank<r>.pt")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """The CLI; returns ``{"model", "state", "history"}`` (under
    ``--model-parallel`` from a plain process: rank 0's report with every
    rank's under ``"ranks"``)."""
    args = parse_args(argv)
    cfg = build_config(args.arch, reduced=args.reduced, t_obj=args.t_obj,
                       backend=args.backend, n_layers=args.layers)
    if args.remat is not None:
        cfg = cfg.replace(remat=args.remat)
    if args.model_parallel != 1:
        return train_tensor_parallel(args, cfg, argv)
    device = resolve_device(args.device)
    model = LM(cfg, generator=torch.Generator(device=device).manual_seed(args.seed),
               device=device)
    print(f"[train] {cfg.name} params={sum(p.numel() for p in model.parameters()):,} "
          f"layers={cfg.n_layers} on {device}", flush=True)
    model, state, history, sup = train_lm(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
        compress=args.compress, seed=args.seed, device=device, model=model,
        log=lambda line: print(line, flush=True), ckpt=args.ckpt, ckpt_every=args.ckpt_every)
    if sup.straggler_events:
        print(f"[ft] {len(sup.straggler_events)} straggler step(s) flagged")
    print(f"[train] done at step {state['step']}"
          + (f"; checkpoints in {args.ckpt}" if args.ckpt else ""))
    return {"model": model, "state": state, "history": history, "supervisor": sup}


# ---------------------------------------------------------------------------
# The sharded train step (--model-parallel N)
# ---------------------------------------------------------------------------

def _refuse(args, cfg: LMConfig, world: int) -> None:
    """What the sharded train step does not run raises here, before any
    rank starts: a model axis that does not divide the world, experts or
    SSD heads that do not split over it (``sharding.check_tp``) and a
    batch that does not split over its ranks."""
    from ..distributed.sharding import check_tp
    N = args.model_parallel
    if N < 1 or world % N:
        raise ValueError(f"--model-parallel {N} does not divide the world of {world} ranks")
    check_tp(cfg, N, train=True)
    parts, _ = batch_shards(cfg, world // N, N, 0, 0)
    data_rows(args.batch, cfg.grad_accum, parts, 0)         # raises if it does not split


def train_tensor_parallel(args, cfg: LMConfig, argv=None) -> dict:
    """``--model-parallel N``: the sharded train step on a ``("data",
    "model")`` mesh. Inside a joined world (``launch.mesh.init_world`` or
    ``spawn``) this process trains as its rank (:func:`train_rank`); from a
    plain process it spawns N ranks on this host (data 1), building the
    kernels first, and returns rank 0's report with every rank's under
    ``"ranks"``."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else args.model_parallel
    _refuse(args, cfg, world)
    if dist.is_initialized():
        return train_rank(args, cfg)
    import sys
    import tempfile

    from ..kernels import build
    from .mesh import spawn
    device = resolve_device(args.device)
    if device.type == "cuda":
        build.load_library()            # once, before the ranks load it
    argv = list(sys.argv[1:] if argv is None else argv)
    with tempfile.TemporaryDirectory() as tmp:
        save = args.save or tmp
        spawn(_spawned_rank, args.model_parallel, (argv, save), device=str(device))
        reports = [torch.load(f"{save}/rank{r}.pt") for r in range(args.model_parallel)]
    return {**reports[0], "ranks": reports}


def _spawned_rank(rank: int, argv: list, save: str) -> None:
    main([*argv, "--save", save])           # the last --save wins


def state_bytes(state: dict) -> dict:
    """The bytes of a train state by component (parameters, optimizer
    moments, int8 residual)."""
    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree.values())
    error = state["compress"].error
    return {"params": nbytes(state["params"]),
            "opt": sum(nbytes(b) for b in state["opt"].values()),
            "compress": 0 if error is None else nbytes(error)}


def train_rank(args, cfg: LMConfig, enc_feats=None) -> dict:
    """This rank's part of ``--model-parallel N`` inside a joined world
    whose size N divides (data = world / N): the mesh
    (``make_host_mesh(model=N)``), the model drawn from ``--seed`` straight
    into this rank's training shards (``sharding.build_sharded(...,
    train=True)``), then :func:`train_lm` on this rank's rows of each
    global batch (``steps.data_rows`` of ``steps.batch_shards``), the
    sharded step, an encoder-decoder also on those rows of the frames
    ``enc_feats(step)`` (the global batch's) when a source is given,
    checkpointing to and resuming from ``--ckpt`` (whole leaves, at any
    layout); at the end the parameters are gathered back into the module. Rank 0 logs as one
    process does. Returns :func:`train_lm`'s result with the mesh and this
    rank's report (``"report"``: the history, the stage times, the peak
    memory, the state's bytes by component and the collectives a step);
    with ``--save`` every rank saves its report."""
    import torch.distributed as dist

    from ..distributed.collectives import DP_TRAFFIC, TP_TRAFFIC, wire_name
    from ..distributed.sharding import build_sharded
    from ..kernels import launch_counters
    from .mesh import make_host_mesh
    t_start = time.perf_counter()
    N, world = args.model_parallel, dist.get_world_size()
    _refuse(args, cfg, world)
    device = resolve_device(args.device)
    if device.type == "cpu":            # the ranks share this host's cores (at most the
        # threads the process was given: OMP_NUM_THREADS=1 makes a run bitwise repeatable)
        torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                         (os.cpu_count() or 1) // world)))
    mesh = make_host_mesh(model=N, device=device)
    data, di, mi = world // N, mesh.get_local_rank("data"), mesh.get_local_rank("model")
    parts, part = batch_shards(cfg, data, N, di, mi)
    rank0 = dist.get_rank() == 0
    log = (lambda line: print(line, flush=True)) if rank0 else (lambda *_: None)
    model = build_sharded(cfg, mesh, generator=torch.Generator(device=device).manual_seed(
        args.seed), device=device, train=True)
    whole = sum(p.numel() for p in LM(cfg, device="meta").parameters())
    log(f"[train] {cfg.name} params={whole:,} layers={cfg.n_layers} "
        f"mesh={{'data': {data}, 'model': {N}}} on {device}, {world} ranks "
        f"({wire_name(mesh.get_group('model'))})")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_build = time.perf_counter()
    before = ({**TP_TRAFFIC}, {**DP_TRAFFIC},
              {k: w.launches for k, w in launch_counters().items()})
    with float32_sums(device):
        model, state, history, sup = train_lm(
            cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
            compress=args.compress, seed=args.seed, device=device, model=model, log=log,
            rows=data_rows(args.batch, cfg.grad_accum, parts, part), enc_feats=enc_feats,
            ckpt=args.ckpt, ckpt_every=args.ckpt_every)
    n = max(len(history), 1)
    t_train = time.perf_counter()
    gather_params_(model, state)        # the module holds the trained weights
    report = {
        "rank": dist.get_rank(), "data_index": di, "model_index": mi,
        "wire": wire_name(mesh.get_group("model")), "history": history,
        "stage_s": {"build": t_build - t_start, "train": t_train - t_build},
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0),
        "state_bytes": state_bytes(state),
        "tp_per_step": {k: (v - before[0][k]) / n for k, v in TP_TRAFFIC.items()},
        "dp_per_step": {k: (v - before[1][k]) / n for k, v in DP_TRAFFIC.items()},
        "launches": {k: w.launches - before[2].get(k, 0)
                     for k, w in launch_counters().items()}}
    if sup.straggler_events:
        log(f"[ft] {len(sup.straggler_events)} straggler step(s) flagged")
    log(f"[train] done at step {state['step']}")
    if args.save is not None:
        torch.save(report, f"{args.save}/rank{dist.get_rank()}.pt")
    return {"model": model, "state": state, "history": history, "supervisor": sup,
            "mesh": mesh, "report": report}


if __name__ == "__main__":
    main()
