"""Host-clock timings of the LM on the card, for the records in PERF.md.

    PYTHONPATH=src python src/repro_torch/launch/lm_timing.py step --label change
    PYTHONPATH=src python src/repro_torch/launch/lm_timing.py depth
    PYTHONPATH=src python src/repro_torch/launch/lm_timing.py serve \
        --arch llama4-scout-17b-a16e --start 14 --by 2 --backend fused

``step`` times gemma3-4b's fused prefill at full width and depth (batch 2
x 2048, T_obj 1.05, warm, three runs) and a training step at full width
cut to 12 layers (batch 2 x 2048 in two microbatches, ``reference``
sites, AdamW, bf16 gradients, no remat; steps 2-4). It uses only entry
points that every checkout since the LM training slice has, so it times
another checkout unchanged: put that checkout's ``src`` first on
``PYTHONPATH`` and compare the two in one call, in turns.

``depth`` trains gemma3-4b at full width with ``remat="block"`` at 34
layers and then 6 fewer at a time (the layer pattern's length) until a
depth takes two steps at K = 1 and at K = 2 (1 x 2048 tokens a
microbatch), and prints each attempt's peak ``max_memory_allocated`` and
its host-clock ms per step; then one step of int8 gradient compression at
the deepest depth found at K = 1. ``--arch`` trains another architecture
the same way, from its full depth down by its pattern's length (or
``--start`` and ``--by``).

``serve`` finds the deepest cut of ``--arch`` that serves on one card:
bf16 weights at full width, ``--start`` layers and then ``--by`` fewer
at a time, each attempt ``serve.serve_one_shot`` on ``--backend`` of
batch 2 x 2048 prompt tokens and 32 greedy tokens and the same call on
``reference`` with the same weights (as chip_smoke holds the two), each
twice in turns; it prints the weight bytes, the peak
``max_memory_allocated`` and the second (warm) host-clock prefill and
decode times, and stops at the first depth that serves. Each line is one
JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import time

import torch

from repro_torch import configs
from repro_torch.data import LMDatasetConfig, lm_batch
from repro_torch.launch import steps
from repro_torch.models.lm import LM
from repro_torch.optim import adamw, warmup_cosine

ARCH, T_OBJ, BATCH, SEQ, GEN = "gemma3-4b", 1.05, 2, 2048, 32


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def _cfg(n_layers: int = 0, arch: str = ARCH, **kw):
    cfg = configs.with_layers(arch, n_layers=n_layers).replace(zebra_t_obj=T_OBJ, **kw)
    if "remat" in {f.name for f in dataclasses.fields(cfg)}:
        cfg = cfg.replace(remat=kw.get("remat", "none"))
    return cfg


def _sync_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _train(cfg, device, n_steps: int, compress: str = "bf16") -> list[float]:
    """Host-clock ms of ``n_steps`` train steps of a fresh model."""
    model = LM(cfg, generator=torch.Generator(device=device).manual_seed(0), device=device)
    opt = adamw(warmup_cosine(3e-4, 1, n_steps))
    state = steps.init_train_state(model, opt, compress)
    tokens = torch.from_numpy(lm_batch(LMDatasetConfig(vocab=cfg.vocab), BATCH, SEQ, 0)
                              ).to(device=device, dtype=torch.int64)
    return [_sync_ms(lambda: steps.train_step(model, opt, state, {"tokens": tokens},
                                              compress=compress))
            for _ in range(n_steps)]


def time_step(device, label: str) -> dict:
    cfg = _cfg(zebra_tnet=False, zebra_backend="fused")
    model = LM(cfg, generator=torch.Generator(device=device).manual_seed(0), device=device)
    tokens = torch.from_numpy(lm_batch(LMDatasetConfig(vocab=cfg.vocab), BATCH, SEQ, 0)
                              ).to(device=device, dtype=torch.int64)[:, :-1]
    prefill = [_sync_ms(lambda: steps.prefill(model, tokens)) for _ in range(4)][1:]
    del model
    torch.cuda.empty_cache()
    train = _train(_cfg(12, zebra_tnet=False, grad_accum=2), device, 4)[1:]
    torch.cuda.empty_cache()
    return {"label": label, "card": _card(), "prefill_ms": prefill, "train_step_ms": train}


def _attempt(row: dict, device, layers: int, k: int, remat: str, n_steps: int = 2,
             compress: str = "bf16", arch: str = ARCH) -> dict:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    row = dict(row, arch=arch, layers=layers, grad_accum=k, remat=remat, compress=compress,
               card=_card())
    try:
        row["ms"] = _train(_cfg(layers, arch, zebra_tnet=False, grad_accum=k, remat=remat),
                           device, n_steps, compress)
        row["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    except torch.cuda.OutOfMemoryError as e:
        row["oom"] = str(e).splitlines()[0]
    print(json.dumps(row), flush=True)
    return row


def find_depth(device, arch: str = ARCH, start: int = 0, by: int = 0) -> None:
    if arch == ARCH:
        for remat in ("none", "block"):     # the cost of remat at 12 layers
            _attempt({"what": "remat cost"}, device, 12, 2, remat, n_steps=3)
    cfg = configs.get(arch)
    deepest = None
    for layers in range(start or cfg.n_layers, 0, -(by or len(cfg.layer_pattern))):
        rows = [_attempt({"what": "depth"}, device, layers, k, "block", arch=arch)
                for k in (1, 2)]
        if deepest is None and "oom" not in rows[0]:
            deepest = layers
        if not any("oom" in r for r in rows):
            break
    if deepest is not None:
        _attempt({"what": "int8"}, device, deepest, 1, "block", n_steps=1, compress="int8",
                  arch=arch)


def _serve_attempt(device, arch: str, layers: int, backend: str, t_obj: float) -> dict:
    from repro_torch.launch import serve
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    row = {"what": "serve depth", "arch": arch, "layers": layers, "backend": backend,
           "t_obj": t_obj, "card": _card()}
    model = None
    try:
        cfg = serve.build_config(arch, t_obj=t_obj, backend=backend, n_layers=layers)
        model = LM(cfg, generator=torch.Generator(device=device).manual_seed(0),
                   device=device).requires_grad_(False)
        row["weight_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
        prompts = torch.from_numpy(lm_batch(LMDatasetConfig(vocab=cfg.vocab), BATCH, SEQ, 0)
                                   [:, :SEQ]).to(device=device, dtype=torch.int64)
        # a first call of each, then the warm times in turns
        for b in (backend, "reference", backend, "reference"):
            out = serve.serve_one_shot(model, prompts, GEN, backend=b, log=lambda *_: None)
            row[f"{b}_prefill_ms"] = out["prefill_ms"]
            row[f"{b}_decode_ms_per_token"] = out["decode_ms_per_token"]
            del out
        row["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    except torch.cuda.OutOfMemoryError as e:
        row["oom"] = str(e).splitlines()[0]
    del model
    print(json.dumps(row), flush=True)
    return row


def find_serve_depth(device, arch: str, start: int, by: int, backend: str,
                     t_obj: float) -> None:
    for layers in range(start, 0, -by):
        if "oom" not in _serve_attempt(device, arch, layers, backend, t_obj):
            break


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["step", "depth", "serve"])
    ap.add_argument("--label", default="")
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--start", type=int, default=0,
                    help="first depth tried (default: the architecture's; serve: 14)")
    ap.add_argument("--by", type=int, default=0,
                    help="layers dropped per attempt (default: the pattern's length; "
                         "serve: 2)")
    ap.add_argument("--backend", default="fused", help="serve: the backend timed")
    ap.add_argument("--t-obj", type=float, default=T_OBJ)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lm_timing: no CUDA device")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    build.load_library()
    if args.what == "step":
        print(json.dumps(time_step(device, args.label)), flush=True)
    elif args.what == "depth":
        find_depth(device, args.arch, args.start, args.by)
    else:
        with torch.inference_mode():
            find_serve_depth(device, args.arch, args.start or 14, args.by or 2,
                             args.backend, args.t_obj)


if __name__ == "__main__":
    main()
