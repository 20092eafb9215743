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
directory under ``/tmp``, which every later run would resume from). Model
parallelism waits for the sharded train step (ROADMAP.md, queue 1, item 1)
and raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import configs
from ..data import LMDatasetConfig, StreamingLoader, lm_batch
from ..ft import FTConfig, StepSupervisor
from ..models.lm import LM, LMConfig
from ..models.lm.remat import REMATS
from ..optim import adamw, warmup_cosine
from ..utils import resolve_device
from .steps import init_train_state, train_step

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
             ckpt_every: int = 25, enc_feats=None):
    """Train ``cfg`` for ``steps`` steps on ``batch`` x ``seq`` tokens of
    the synthetic stream (seed ``seed``), an encoder-decoder also on the
    frames ``enc_feats(step)`` (B, enc_seq, d) of each loader step when a
    source is given; ``model`` (else a new one, its
    weights drawn from a ``torch.Generator`` seeded ``seed`` on the
    device) is trained in place, under a ``StepSupervisor`` that
    checkpoints to ``ckpt`` (None: no checkpoints) every ``ckpt_every``
    steps and resumes from it. Returns ``(model, state, history,
    supervisor)``: one history row per completed step, the metrics read
    on the host (one read a step, after the finite-loss check's) with
    ``step`` and ``ms``, the step's host-clock time."""
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
        out = {"tokens": lm_batch(ds, b, seq, s)}
        if enc_feats is not None:
            out["enc_feats"] = enc_feats(s)
        return out
    loader = StreamingLoader(make_batch, batch)
    sup = StepSupervisor(FTConfig(ckpt_dir=ckpt, ckpt_every=ckpt_every))
    state, start, extra = sup.resume_or_init(lambda: init_train_state(model, opt, compress))
    loader.restore(extra.get("loader_step", start))

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


def main(argv=None) -> dict:
    """The CLI; returns ``{"model", "state", "history"}``."""
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
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        raise NotImplementedError("--model-parallel > 1: the sharded train step of the "
                                  "distributed LM is not ported yet (ROADMAP.md, queue 1, "
                                  "item 1; serving runs tensor-parallel: launch.serve)")
    device = resolve_device(args.device)
    cfg = build_config(args.arch, reduced=args.reduced, t_obj=args.t_obj,
                       backend=args.backend, n_layers=args.layers)
    if args.remat is not None:
        cfg = cfg.replace(remat=args.remat)
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


if __name__ == "__main__":
    main()
