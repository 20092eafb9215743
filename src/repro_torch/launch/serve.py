"""LM serving (``repro.launch.serve``), a thin CLI over two paths:

* one-shot batch (default): prefill a batch of prompts, hand the KV caches
  to decode in compressed form (on the ``stream`` and ``fused``
  backends), decode, and report the Zebra observables and the bytes the
  handoff moved;
* continuous batching (``--requests N``): serve a synthetic trace of N
  requests through ``serve.ServeEngine``: admission, the slotted decode
  across in-flight requests at different positions, and a paged pool of
  compressed KV slabs, with deadlines (``--deadline-ticks``), a bounded
  queue (``--queue-bound``) and the crash-recoverable loop
  (``--supervise``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \\
        --backend fused --batch 2 --prompt-len 2048 --gen 32 --t-obj 1.05
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \\
        --backend fused --requests 16 --slots 8 --prompt-len 512 --gen 32 \\
        --t-obj 1.05 --validate structural --preempt-after 64

``--arch`` takes the ported architectures: the dense ones (gemma3-4b,
command-r-35b, qwen2.5-14b, starcoder2-15b, chameleon-34b), the MoE ones
(granite-moe-1b-a400m, llama4-scout-17b-a16e), the encoder-decoder
whisper-medium, whose encoder is fed zero frames (B, enc_seq, d) in bf16,
as the reference's server feeds it, and the recurrent ones, mamba2-2.7b
(its handoff carries the float32 SSD state and the conv buffers) and
recurrentgemma-2b (the RG-LRU states beside the local K/V); ``--layers
N`` keeps the first N layers at full width (for a model whose full depth
does not fit one card), ``--encoder-layers N`` the first N of whisper's
encoder layers. It runs on the card; ``--device cpu`` runs it on the CPU
(the kernels' plain versions). Weights are random from seed 0, prompts come
from ``data.lm_batch``. ``--validate structural|checksum`` checks every
stream at its producer -> consumer boundary (``core.engine``) and every
compressed cache leaf of the handoff (:func:`validate_state_ingest`),
recovering a failed one from its dense source, and the continuous
engine's pages at ingest.

``--model-parallel N`` serves every architecture one-shot on a
``("data", "model")`` mesh (:func:`serve_tensor_parallel`), the batch over
``data`` and over ``model`` what the reference's specs split there: the
heads (a count that does not divide N stays whole, its attention
replicated), ``d_ff``, the vocabulary, the experts (expert parallelism,
dispatched over the global batch), Mamba-2's ``d_inner`` and heads, the
RG-LRU's ``lru_dim``, and whisper's encoder and cross-attention heads (its
frames split over ``data``); on every backend, with the compressed handoff
and ``--validate``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
        --model-parallel 4 --backend fused --batch 2 --prompt-len 2048 \
        --gen 32 --t-obj 1.05
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --model-parallel 4 --backend stream --batch 2 --prompt-len 2048 \
        --gen 32 --t-obj 5.0

From a plain shell it spawns N ranks on this host (on one card they share
it, over ``gloo``); inside a joined world of a multiple of N ranks each
process serves as its rank.

``--requests`` under ``--model-parallel N`` runs the continuous engine on
the sharded model (:func:`serve_continuous` in every rank): the prefills
and the slotted decode tensor-parallel, each rank holding its K/V heads of
the hot set and paging them to its own pool, which meters the whole
cache's pages as one process's does; every rank takes the same decision
at every tick (``serve.engine``). In a joined world of D·N ranks (data D
> 1) a hot set whose lanes D divides is split over ``data``, each data
rank decoding its block of lanes, and any other, like every prefill, runs
whole on every data rank, as the reference's ``batch_spec`` lays it out.
The architectures are those ``ServeEngine`` takes (the decoder-only
attention stacks: the dense and MoE LMs); every continuous flag works.
Rank 0 prints the report; with ``--save`` every rank saves it with its
pool's counters, its hot set's lanes by bucket, its launches and
collectives and its peak memory. From a plain shell it spawns N ranks
(data 1):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
        --model-parallel 4 --backend fused --requests 8 --slots 4 \
        --prompt-len 320 --gen 16 --t-obj 1.05 --validate structural \
        --preempt-after 16 --page-tokens 64 --layers 6
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import math
import os
import time

import torch

from .. import configs
from ..compress import BandwidthMeter, CompressedMap, compress_tree, decompress
from ..compress.integrity import validate_map
from ..ft.breaker import active_board
from ..ft.faults import CorruptStream
from ..ft.inject import STREAM_KINDS, active_plan, corrupt_map
from ..data import LMDatasetConfig, lm_batch
from ..models.lm import LM, LMConfig
from ..serve.bucket import pow2_bucket
from ..utils import float32_sums, map_tree, resolve_device
from ..distributed.ctx import tensor_parallel
from .steps import _next_token, generate, model_hints, prefill

COMPRESSED_BACKENDS = ("stream", "fused")


def build_config(arch: str, *, reduced: bool = False, t_obj: float = 0.1,
                 backend: str = "reference", validation: str = "off",
                 n_layers: int = 0, encoder_layers: int = 0) -> LMConfig:
    """The served config: bf16 weights and the ``kv_cache`` site on top of
    the architecture's Zebra sites, as the reference server sets them;
    ``n_layers`` > 0 keeps the first that many layers (at most the
    architecture's depth), ``encoder_layers`` > 0 the first that many of an
    encoder-decoder's encoder layers."""
    cfg = configs.with_layers(arch, reduced=reduced, n_layers=n_layers)
    if encoder_layers:
        if not 0 < encoder_layers <= cfg.encoder_layers:
            raise ValueError(f"encoder_layers {encoder_layers}: {cfg.name} has "
                             f"{cfg.encoder_layers} encoder layers")
        cfg = cfg.replace(encoder_layers=encoder_layers)
    return cfg.replace(param_dtype="bfloat16",
                       zebra_sites=tuple(cfg.zebra_sites) + ("kv_cache",),
                       zebra_t_obj=t_obj, zebra_backend=backend,
                       zebra_validation=validation)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve_one_shot(model: LM, prompts: torch.Tensor, gen: int, *, backend: str | None = None,
                   temperature: float = 0.0, seed: int = 0, log=print,
                   enc_feats: torch.Tensor | None = None, keep_logits: bool = False) -> dict:
    """Prefill ``prompts`` (B, S) (an encoder-decoder encodes its frames
    ``enc_feats`` first), hand the caches over (compressed on the
    stream/fused backends; the encoder output goes on dense), decode
    ``gen`` tokens in all. Returns the
    tokens, the prefill's first logits and LayerAux, the handoff's meter
    and reconcile result, the caches before the handoff (dense) and as
    handed over (``CompressedMap`` leaves where compressed, which decode
    expands into new tensors; a leaf handed over dense is updated in place
    by decode), the count of handoff leaves that failed ingest validation
    and were recovered dense, and the host-clock times (synchronised on
    the card). ``backend`` serves this call on another site backend with
    the same weights: the model reads its config at every call, so the
    call swaps it in and restores the model's own after. With
    ``keep_logits`` the logits each token was chosen from come back as
    ``step_logits`` (the prefill's, then each decode step's). Under a
    tensor-parallel model's mesh it also returns ``phases``, each phase's
    kernel launches and tensor-parallel collectives, and checks that every
    model rank holds the same logits and tokens bit for bit."""
    if backend is not None and backend != model.cfg.zebra_backend:
        own = model.cfg
        model.cfg = own.replace(zebra_backend=backend)
        try:
            return serve_one_shot(model, prompts, gen, temperature=temperature, seed=seed,
                                  log=log, enc_feats=enc_feats, keep_logits=keep_logits)
        finally:
            model.cfg = own
    cfg = model.cfg
    device = prompts.device
    backend = cfg.zebra_backend
    generator = torch.Generator(device=device).manual_seed(seed)
    B, S = prompts.shape

    with model_hints(model):
        tp = tensor_parallel()
        phases = _PhaseMarks(tp is not None)
        _sync(device)
        t0 = time.perf_counter()
        logits, state, aux = model_prefill_pad(lambda t: prefill(model, t, enc_feats),
                                               prompts, S + gen)
        _sync(device)
        t_pref = time.perf_counter() - t0
        phases.mark("prefill")
        if tp is not None:
            check_replicated(logits, tp.model, "prefill logits")
        dense_state = handoff = state
        meter, rec, recovered = None, None, 0
        if backend in COMPRESSED_BACKENDS:
            meter = BandwidthMeter()
            handoff, rec, recovered = transport_state_compressed(
                state, cfg, meter=meter, log=log, validation=cfg.zebra_validation)
        phases.mark("handoff")
        tok = _next_token(logits, temperature, generator)

        step_logits = [logits] if keep_logits else None
        _sync(device)
        t0 = time.perf_counter()
        toks, _ = generate(model, tok, handoff, S, max(gen - 1, 0), temperature, generator,
                           step_logits)
        _sync(device)
        t_dec = time.perf_counter() - t0
        phases.mark("decode")
        tokens = torch.cat([tok, toks], dim=1)[:, :gen]
        if tp is not None:
            check_replicated(tokens, tp.model, "tokens")
    return {"tokens": tokens, "logits": logits, "aux": aux, "meter": meter,
            "reconcile": rec, "dense_state": dense_state, "handoff_state": handoff,
            "ingest_recovered": recovered,
            "prefill_ms": t_pref * 1e3,
            "decode_ms_per_token": t_dec / max(gen - 1, 1) * 1e3,
            "phases": phases.deltas, "step_logits": step_logits}


class _PhaseMarks:
    """Under tensor parallelism, the kernel launches and the tensor-parallel
    and data-parallel collectives (calls and the bytes a rank handed in) of
    each serving phase; empty otherwise."""

    def __init__(self, on: bool):
        self.on, self.deltas = on, {}
        self._last = self._read() if on else None

    @staticmethod
    def _read() -> dict:
        from ..distributed.collectives import DP_TRAFFIC, TP_TRAFFIC
        from ..kernels import launch_counters
        return {**{k: w.launches for k, w in launch_counters().items()},
                **{f"tp_{k}": v for k, v in TP_TRAFFIC.items()},
                **{f"dp_{k}": v for k, v in DP_TRAFFIC.items()}}

    def mark(self, phase: str) -> None:
        if self.on:
            now = self._read()
            self.deltas[phase] = {k: now[k] - self._last[k] for k in now}
            self._last = now


def check_replicated(t: torch.Tensor, axis, what: str) -> None:
    """Raise unless every rank of ``axis`` holds ``t`` bit for bit: a model
    rank that drifted would take other tokens and desynchronise decode."""
    from ..distributed.collectives import tp_all_gather
    raw = tp_all_gather(t.reshape(1, -1), axis, 0).view(torch.uint8)
    if not bool((raw == raw[axis.index]).all()):
        raise RuntimeError(f"{what} differ between the ranks of the {axis.name!r} axis")


def main(argv=None) -> dict:
    """The CLI; returns ``serve_one_shot``'s result with the model and the
    prompts, or with ``--requests`` :func:`serve_continuous`'s."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--layers", type=int, default=0,
                    help="serve only the first N layers at full width (0: the "
                         "architecture's depth)")
    ap.add_argument("--encoder-layers", type=int, default=0,
                    help="an encoder-decoder: serve only the first N encoder layers "
                         "(0: all)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--t-obj", type=float, default=0.1)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy argmax; > 0 samples from the softmax at this "
                         "temperature (seeded by --seed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="reference",
                    choices=["reference", "pallas", "stream", "fused"],
                    help="Zebra site-engine backend for every activation site; "
                         "stream/fused also hand the prefill->decode KV caches "
                         "over compressed")
    ap.add_argument("--validate", default="off",
                    choices=["off", "structural", "checksum"],
                    help="stream-integrity level (compress.integrity): the engine's "
                         "producer->consumer checks and the validation of the "
                         "prefill->decode cache handoff, each failure recovered "
                         "from its dense source")
    ap.add_argument("--requests", type=int, default=0,
                    help="continuous-batching mode: serve a synthetic trace of N "
                         "requests (serve.ServeEngine) instead of the one-shot batch")
    ap.add_argument("--slots", type=int, default=4,
                    help="in-flight request lanes (continuous mode)")
    ap.add_argument("--page-tokens", type=int, default=16,
                    help="cache positions per compressed KV page")
    ap.add_argument("--preempt-after", type=int, default=0,
                    help="evict a lane to the compressed pool after this many "
                         "consecutive steps while requests wait (0 = never)")
    ap.add_argument("--deadline-ticks", type=int, default=0,
                    help="per-request TTL in engine ticks (continuous mode): a "
                         "request that cannot finish by arrival + TTL given the "
                         "slot clock is shed at admission, and a lane past its TTL "
                         "is cancelled mid-flight (0 = no deadlines)")
    ap.add_argument("--queue-bound", type=int, default=0,
                    help="bounded pending queue (continuous mode): arrived "
                         "waiters beyond this count are shed, newest fresh "
                         "arrivals first (0 = unbounded)")
    ap.add_argument("--supervise", action="store_true",
                    help="run the continuous engine loop under the "
                         "crash-recoverable supervisor (per-tick snapshots and "
                         "classified restore with backoff)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (no fallback); 'cpu' runs the "
                         "kernels' plain versions on the CPU")
    ap.add_argument("--params", default=None,
                    help="a torch.save'd {dotted parameter name: whole tensor} dict "
                         "loaded over the seed-0 weights (names it lacks keep their "
                         "draws); under --model-parallel each rank keeps its shard")
    ap.add_argument("--save", default=None,
                    help="--model-parallel: each rank also saves its report (tokens, "
                         "logits, sites, handoff records, times, memory, launches and "
                         "collectives by phase) to DIR/rank<r>.pt")
    ap.add_argument("--record", action="store_true",
                    help="--model-parallel, for checks: the report also holds every "
                         "site's keep flags and, on each data rank's first rank, the "
                         "logits of every token, kept on the card during the run and "
                         "read after it")
    args = ap.parse_args(argv)
    cfg = build_config(args.arch, reduced=args.reduced, t_obj=args.t_obj,
                       backend=args.backend, validation=args.validate,
                       n_layers=args.layers, encoder_layers=args.encoder_layers)
    if args.model_parallel != 1:
        return serve_tensor_parallel(args, cfg, argv)

    device = resolve_device(args.device)
    _no_tf32(device)
    model = LM(cfg, generator=torch.Generator(device=device).manual_seed(0),
               device=device).requires_grad_(False)
    if args.params is not None:
        load_params_(model, args.params)
    if args.requests:
        return serve_continuous(args, model)

    B, S = args.batch, args.prompt_len
    prompts = _prompts(cfg, B, S, device)
    enc = (torch.zeros((B, cfg.enc_seq, cfg.d_model), dtype=torch.bfloat16, device=device)
           if cfg.encoder_layers else None)
    out = serve_one_shot(model, prompts, args.gen, temperature=args.temperature,
                         seed=args.seed, enc_feats=enc)
    _print_report(cfg, out, B, S, args.gen, device)
    out["model"], out["prompts"] = model, prompts
    return out


def load_params_(model: LM, path: str, mesh=None) -> None:
    """Load the whole tensors in ``path`` (a ``torch.save``'d {dotted
    parameter name: tensor} dict, read through a memory map) over the
    model's parameters of those names, in the parameters' dtype; under
    ``mesh`` (a model cut to its serving shards) each takes this rank's
    shard of its tensor. Every name must be a parameter of the model with
    that whole shape."""
    from ..distributed.sharding import local_shard, serving_shardings
    sd = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
    params = dict(model.named_parameters())
    unknown = sorted(set(sd) - set(params))
    if unknown:
        raise KeyError(f"--params {path}: not parameters of {model.cfg.name}: {unknown[:5]}")
    places = None if mesh is None else serving_shardings(sd, model.cfg, mesh)
    with torch.no_grad():
        for name, t in sd.items():
            part = t if mesh is None else local_shard(t, places[name], mesh, axes=("model",))
            if part.shape != params[name].shape:
                raise ValueError(f"--params {path}: {name} {tuple(t.shape)} does not make "
                                 f"this rank's {tuple(params[name].shape)}")
            params[name].copy_(part)


def _no_tf32(device: torch.device) -> None:
    if device.type == "cuda":
        # full float32 for every float32 matmul, as the reference computes it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _prompts(cfg: LMConfig, B: int, S: int, device) -> torch.Tensor:
    prompts = torch.from_numpy(lm_batch(LMDatasetConfig(vocab=cfg.vocab), B, S, 0)[:, :S])
    return prompts.to(device=device, dtype=torch.int64)


def _print_report(cfg: LMConfig, out: dict, B: int, S: int, gen: int, device,
                  where: str = "") -> None:
    aux = out["aux"]
    print(f"[serve] {cfg.name} batch={B} prompt={S} gen={gen} on {device}{where}")
    print(f"  prefill: {out['prefill_ms']:.1f} ms  decode: "
          f"{out['decode_ms_per_token']:.2f} ms/token")
    if float(aux.n_blocks) > 0:
        print(f"  zebra zero-block fraction, all prefill sites: {float(aux.zero_frac):.3f}")
    else:
        print("  zebra: no block-divisible site this shape — zero-block fraction n/a")
    measured = aux.measured_bytes_exact()
    if measured > 0:
        print(f"  zebra in-model transport: {measured / 1e6:.3f} MB measured "
              f"compressed stream bytes (prefill sites)")
    print("  sample continuation:", out["tokens"][0, :16].tolist())


# ---------------------------------------------------------------------------
# Tensor-parallel one-shot serving (--model-parallel N)
# ---------------------------------------------------------------------------

def serve_tensor_parallel(args, cfg: LMConfig, argv=None) -> dict:
    """``--model-parallel N``: one-shot serving on a ``("data", "model")``
    mesh, N ranks a model replica, the batch split over ``data``. Inside a
    joined world (``launch.mesh.init_world`` or ``spawn``) this process
    serves as its rank (:func:`serve_rank`); from a plain process it
    spawns N ranks on this host (data 1), building the kernels first, and
    returns rank 0's report with every rank's under ``"ranks"``. What the
    slice does not serve raises here, before anything launches."""
    import torch.distributed as dist

    from ..distributed.sharding import check_tp
    if args.model_parallel < 1:
        raise ValueError(f"--model-parallel {args.model_parallel}: at least 1")
    check_tp(cfg, args.model_parallel)
    if args.requests:
        from ..serve.engine import check_servable
        check_servable(cfg)
    if dist.is_initialized():
        return serve_rank(args, cfg)
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


def serve_rank(args, cfg: LMConfig) -> dict:
    """This rank's part of ``--model-parallel N`` inside a joined world
    whose size N divides: the mesh (``make_host_mesh(model=N)``), the model
    drawn from seed 0 straight into this rank's shards
    (``sharding.build_sharded``; ``--params`` loaded over it), this data
    rank's rows of the prompts, then :func:`serve_one_shot` with its sites
    recorded (with ``--requests``, :func:`serve_continuous` on every rank,
    its lanes over ``data``: ``serve.engine``). Rank 0 prints the report;
    with ``--save`` every rank saves :func:`tp_report` (with ``--record``
    the sites' keep flags and, on each data rank's first rank, the logits
    of every token). The peak memory of the build is reported beside the
    serving peak."""
    import torch.distributed as dist

    from ..core.engine import record_tp_sites, tp_sites_on_host
    from ..distributed.sharding import build_sharded
    from .mesh import make_host_mesh
    t_start = time.perf_counter()
    N, world = args.model_parallel, dist.get_world_size()
    if world % N:
        raise ValueError(f"--model-parallel {N} does not divide the world of {world} ranks")
    device = resolve_device(args.device)
    _no_tf32(device)
    if device.type == "cpu":            # the ranks share this host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = make_host_mesh(model=N, device=device)
    if device.type == "cuda":           # this run's peaks, not an earlier run's in the process
        torch.cuda.reset_peak_memory_stats(device)
    data = world // N
    B, S = args.batch, args.prompt_len
    if B % data and not args.requests:
        raise ValueError(f"batch {B} does not split over {data} data ranks")
    t_mesh = time.perf_counter()
    model = build_sharded(cfg, mesh, generator=torch.Generator(device=device).manual_seed(0),
                          device=device).requires_grad_(False)
    if args.params is not None:
        load_params_(model, args.params, mesh)
    build_peak = 0
    if device.type == "cuda":
        build_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t_build = time.perf_counter()
    rank0 = dist.get_rank() == 0
    if args.requests:
        return _serve_rank_continuous(args, cfg, mesh, model, device, rank0,
                                      {"mesh": t_mesh - t_start, "build": t_build - t_mesh},
                                      build_peak)
    rows = B // data
    di = mesh.get_local_rank("data")
    prompts = _prompts(cfg, B, S, device)[di * rows:(di + 1) * rows]
    enc = (torch.zeros((rows, cfg.enc_seq, cfg.d_model), dtype=torch.bfloat16, device=device)
           if cfg.encoder_layers else None)     # this data rank's frames
    with record_tp_sites(bitmaps=args.record) as sites, float32_sums(device):
        out = serve_one_shot(model, prompts, args.gen, temperature=args.temperature,
                             seed=args.seed, log=print if rank0 else (lambda *_: None),
                             enc_feats=enc,
                             keep_logits=args.record and mesh.get_local_rank("model") == 0)
    t_serve = time.perf_counter()
    out["sites"] = tp_sites_on_host(sites)
    out["build_peak_memory"] = build_peak
    out["max_memory_allocated"] = (torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else 0)
    out["stage_s"] = {"mesh": t_mesh - t_start, "build": t_build - t_mesh,
                      "serve": t_serve - t_build}
    if rank0:
        _print_report(cfg, out, B, S, args.gen, device,
                      f", {world} ranks (data {data}, model {N})")
    if args.save is not None:
        torch.save(tp_report(out, mesh), f"{args.save}/rank{dist.get_rank()}.pt")
    out["model"], out["prompts"], out["mesh"] = model, prompts, mesh
    return out


def _serve_rank_continuous(args, cfg: LMConfig, mesh, model: LM, device, rank0: bool,
                           stage_s: dict, build_peak: int) -> dict:
    """``--requests`` on this rank: :func:`serve_continuous` on its shards,
    its sites recorded; with ``--save`` the rank's
    :func:`continuous_tp_report`."""
    import torch.distributed as dist

    from ..core.engine import record_tp_sites, tp_sites_on_host
    t0 = time.perf_counter()
    phases = _PhaseMarks(True)
    with record_tp_sites() as sites, float32_sums(device):
        out = serve_continuous(args, model, log=print if rank0 else (lambda *_: None))
    phases.mark("serve")
    out["sites"] = tp_sites_on_host(sites)
    out["phases"] = phases.deltas
    out["build_peak_memory"] = build_peak
    out["max_memory_allocated"] = (torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else 0)
    out["stage_s"] = {**stage_s, "serve": time.perf_counter() - t0}
    if args.save is not None:
        torch.save(continuous_tp_report(out, mesh), f"{args.save}/rank{dist.get_rank()}.pt")
    out["mesh"] = mesh
    return out


def continuous_tp_report(out: dict, mesh) -> dict:
    """A rank's continuous-serving result on the host: the engine's report,
    every request's status, shed reason and tokens, the pool's counters
    and meter records, the lanes of the hot set it held at each batch
    bucket and its lanes broadcast over ``data`` (count, host seconds),
    the sites, launches and collectives of the run, and its
    memory."""
    import torch.distributed as dist

    from ..distributed.collectives import wire_name
    eng = out["engine"]
    pool = eng.pool
    return {"rank": dist.get_rank(), "data_index": mesh.get_local_rank("data"),
            "model_index": mesh.get_local_rank("model"),
            "wire": wire_name(mesh.get_group("model")), "report": out["report"],
            "requests": {r.rid: (r.status, r.shed_reason, list(r.out))
                         for r in eng.scheduler.completed},
            "pool": {k: getattr(pool, k) for k in POOL_COUNTERS},
            "records": [(r.site, r.payload_bytes, r.index_bytes, r.dense_bytes, r.n_live,
                         r.n_blocks) for r in pool.meter.records],
            "decode_shapes": sorted(eng._decode_shapes),
            "prefill_shapes": sorted(eng._prefill_shapes),
            "hot_lanes": dict(sorted(eng.hot_lanes.items())),
            "lane_broadcasts": eng.lane_broadcasts, "seconds_broadcast": eng.seconds_broadcast,
            "sites": out["sites"], "phases": out["phases"],
            "build_peak_memory": out["build_peak_memory"],
            "max_memory_allocated": out["max_memory_allocated"], "stage_s": out["stage_s"]}


POOL_COUNTERS = ("n_pages_out", "n_pages_in", "n_recovered", "n_breaker_dense",
                 "bytes_out", "bytes_in", "seconds_out", "seconds_in")


def tp_report(out: dict, mesh) -> dict:
    """A rank's serving result on the host, for the process that spawned it."""
    import torch.distributed as dist

    from ..distributed.collectives import wire_name
    aux = out["aux"]
    meter = out["meter"]
    return {"rank": dist.get_rank(), "data_index": mesh.get_local_rank("data"),
            "model_index": mesh.get_local_rank("model"),
            "wire": wire_name(mesh.get_group("model")),
            "tokens": out["tokens"].cpu(), "logits": out["logits"].float().cpu(),
            "n_blocks": float(aux.n_blocks), "zero_frac": aux.zero_frac.cpu(),
            "measured_bytes": aux.measured_bytes_exact(),
            "records": [] if meter is None else [dataclasses.asdict(
                dataclasses.replace(r, spec=None)) | {"predicted": r.predicted_bytes}
                for r in meter.records],
            "reconcile": out["reconcile"], "ingest_recovered": out["ingest_recovered"],
            "prefill_ms": out["prefill_ms"],
            "decode_ms_per_token": out["decode_ms_per_token"],
            "phases": out["phases"], "sites": out["sites"],
            "build_peak_memory": out["build_peak_memory"],
            "max_memory_allocated": out["max_memory_allocated"], "stage_s": out["stage_s"],
            "step_logits": (None if out["step_logits"] is None else
                            torch.stack([x.float().cpu() for x in out["step_logits"]]))}


def continuous_trace(requests: int, vocab: int, prompt_len: int, gen: int, *, seed: int = 0,
                     deadline_ticks: int = 0) -> list:
    """The CLI's synthetic trace: ``requests`` prompts of prompt_len/4 to
    prompt_len tokens, each generating gen/4 to gen, all arriving at tick 0
    (``serve.synthetic_trace``, as the reference's CLI draws it)."""
    from ..serve import synthetic_trace
    return synthetic_trace(requests, vocab=vocab, seed=seed,
                           prompt_lo=max(prompt_len // 4, 4), prompt_hi=prompt_len,
                           gen_lo=max(gen // 4, 1), gen_hi=gen,
                           deadline_ticks=deadline_ticks or None)


def serve_continuous(args, model: LM, log=print) -> dict:
    """``--requests N``: run a synthetic trace through the continuous-batching
    engine and print its report (through ``log``). Returns the report, the
    engine (its scheduler holds the served requests, its pool the meter),
    the trace and the model. On a model cut for a mesh every rank serves
    the whole trace on its shards."""
    from ..ft import FTConfig
    from ..serve import ServeEngine
    from ..serve.bucket import pow2_ceil

    cfg = model.cfg
    eng = ServeEngine(model, n_slots=args.slots,
                      max_cache_len=pow2_ceil(args.prompt_len + args.gen),
                      page_tokens=args.page_tokens, validation=args.validate,
                      temperature=args.temperature, seed=args.seed,
                      queue_bound=args.queue_bound)
    trace = continuous_trace(args.requests, cfg.vocab, args.prompt_len, args.gen,
                             seed=args.seed, deadline_ticks=args.deadline_ticks)
    ft_cfg = FTConfig(jitter_seed=args.seed) if args.supervise else None
    rep = eng.run(trace, preempt_after=args.preempt_after, ft_cfg=ft_cfg)
    where = ""
    if eng.pool.tp is not None:
        tp = eng.pool.tp
        where = f", {tp.world.size} ranks (data {tp.data.size}, model {tp.model.size})"
    log(f"[serve] {cfg.name} continuous: {rep['n_requests']} requests "
        f"({rep['n_rejected']} rejected, {rep['n_shed']} shed, "
        f"{rep['deadline_misses']} deadline misses) in "
        f"{rep['wall_s']:.2f} s over {args.slots} slots on {eng.device}{where}")
    log(f"  {rep['requests_per_s']:.2f} req/s  {rep['tokens_per_s']:.1f} "
        f"tok/s  p50 {rep['p50_token_ms']:.1f} ms/token  "
        f"p95 {rep['p95_token_ms']:.1f} ms/token  "
        f"evictions {rep['evictions']}")
    log(f"  KV stream: {rep['kv_bytes_measured']/1e6:.3f} MB measured "
        f"(dense {rep['kv_bytes_dense']/1e6:.3f} MB) over "
        f"{rep['kv_pages']} pages, zero-block fraction "
        f"{rep['zero_frac']:.3f}, {rep['pages_recovered']} pages "
        f"recovered dense")
    log(f"  dispatch shapes: decode {rep['decode_shapes']}"
        f"/{rep['decode_shape_bound']}  prefill {rep['prefill_shapes']}"
        f"/{rep['prefill_shape_bound']}  reconcile max "
        f"|measured-predicted| {rep['reconcile_max_delta_bytes']:.2f} B")
    return {"report": rep, "engine": eng, "trace": trace, "model": model}


def validate_state_ingest(cstate, dense_state, level: str, site: str = "serve",
                          breaker=None, log=print):
    """Validate every ``CompressedMap`` leaf of a handoff tree at the
    consumer boundary. A corrupt leaf is replaced by its dense source (the
    ``ft.faults`` policy "recompute-dense", per leaf), so one bad stream
    degrades one cache's transport, not the batch. A fault plan armed
    with ``ft.inject`` with a stream fault at ``site`` corrupts leaves
    here, after compression and before validation.

    The handoff is also a circuit-breaker boundary: with a
    ``ft.breaker.BreakerBoard`` passed (or armed ambiently with
    ``breaker_scope``), per-leaf detections feed its trip window, and with
    the site open the whole tree goes dense, with no per-leaf validation,
    until half-open probes pass. Returns ``(tree, n_recovered)``."""
    dense_leaves = _leaves(dense_state)
    board = breaker if breaker is not None else active_board()
    if board is not None:
        board.tick()                        # call-counted breaker clock
        if not board.allow(site):
            return _map_leaves(lambda i, c: dense_leaves[i]
                               if isinstance(c, CompressedMap) else c, cstate), 0
    plan = active_plan()
    n_bad = 0

    def one(i, c):
        nonlocal n_bad
        if not isinstance(c, CompressedMap):
            return c
        if plan is not None:
            f = plan.take(STREAM_KINDS, site)
            if f is not None:
                c = corrupt_map(c, f.kind, arg=f.arg)
                plan.note(f.kind, site)
        try:
            validate_map(c, level=level, site=f"{site}:leaf{i}")
        except CorruptStream as e:
            n_bad += 1
            if board is not None:
                board.record_failure(site)
            log(f"[serve] {e} — leaf {i} recovered from its dense source")
            return dense_leaves[i]
        if board is not None and level != "off":
            board.record_success(site)
        return c

    return _map_leaves(one, cstate), n_bad


def transport_state_compressed(state, cfg: LMConfig, meter: BandwidthMeter | None = None,
                               log=print, validation: str = "off"):
    """The prefill -> decode handoff in compressed form: pack every
    compatible cache leaf (lossless nonzero-block bitmap, ``zebra_pack``),
    count the bytes moved on ``meter``, reconcile each leaf against Eq. 2/3
    (raises on the first leaf outside the band), and return the caches in
    payload form with the reconcile result and the count of leaves
    recovered dense. The first compressed leaf is spot-checked lossless.
    With ``validation`` other than off, every compressed leaf is checked
    on ingest (:func:`validate_state_ingest`); at ``checksum`` each is
    sealed with its checksum when packed."""
    caches, enc_out = state
    meter = BandwidthMeter() if meter is None else meter
    tp = tensor_parallel()
    if tp is None:
        ccaches = compress_tree(caches, bs=cfg.zebra_block_seq, bc=cfg.zebra_block_ch,
                                meter=meter, site="kv", checksum=(validation == "checksum"))
    else:
        ccaches = compress_tree_tp(caches, cfg, tp, meter=meter,
                                   checksum=(validation == "checksum"))
    sampled = [(a, c) for a, c in zip(_leaves(caches), _leaves(ccaches))
               if isinstance(c, CompressedMap)]
    ok = not sampled or bool(torch.equal(sampled[0][0], decompress(sampled[0][1])))
    rec = meter.reconcile(tol_bytes_per_map=1.0)
    log("[serve] compressed KV-cache transport (prefill -> decode, payload form):")
    log(meter.report())
    log(f"  lossless (leaf 1 of {len(sampled)} checked): {ok}"
        f"  reconcile: {rec['n_sites']} sites, every leaf within the "
        f"index-padding bound, max |measured - predicted| = "
        f"{rec['max_abs_delta_bytes']:.2f} B")
    if rec["n_sites"] == 0:
        log("  WARNING: no cache leaf was block-divisible — every leaf moved dense; "
            "pick batch/prompt-len/gen so that batch*(prompt+gen) divides by "
            "zebra_block_seq")
    n_bad = 0
    if validation != "off":
        ccaches, n_bad = validate_state_ingest(ccaches, caches, validation, log=log)
        log(f"  ingest validation ({validation}): "
            f"{'clean' if n_bad == 0 else f'{n_bad} leaf(s) recovered dense'}")
    return (ccaches, enc_out), rec, n_bad


# a cache leaf's batch dimension and the dimension the reference's
# ``cache_specs`` split over the model axis, with the config field of that
# dimension's whole extent (sharding.cache_spec_for)
CACHE_AXES = {"k": (-4, -2, "n_kv_heads"), "v": (-4, -2, "n_kv_heads"),
              "H": (-4, -3, "ssm_heads"), "conv_x": (-3, -1, "d_inner"),
              "conv_b": (-3, None, None), "conv_c": (-3, None, None),
              "h": (-2, -1, "lru_dim"), "conv": (-3, -1, "lru_dim")}


def compress_tree_tp(caches, cfg: LMConfig, tp, *, meter: BandwidthMeter,
                     checksum: bool = False):
    """The handoff's compression under tensor parallelism. Each leaf holds
    this rank's rows of the batch and, where the reference's cache specs
    split it over the model axis (:data:`CACHE_AXES`: K/V on their heads,
    Mamba-2's ``H`` on its heads, ``conv_x`` and the RG-LRU's ``h`` and
    ``conv`` on their channels), this rank's part of that dimension, else
    all of it. It is compressed as the reference compresses the whole
    leaf, its flattening (``stream.leaf_dims``) taken from the whole leaf's
    shape. A rank's part along an axis that falls on block edges of that
    flattening is packed as it is (``compress.stream.pack_plan``, the
    paged pool's rule too); along any other the leaf is gathered over that
    axis, packed whole (kernel 5) and
    expanded whole at decode (kernel 3), each rank keeping its part
    (``CompressedMap.part``). Every leaf goes on ``meter`` once, with the
    whole leaf's counts: its live blocks summed over the ranks that own
    them (a replicated or gathered leaf is the first rank's of that
    axis)."""
    from ..compress.stream import compress as compress_map, leaf_dims, pack_plan
    from ..distributed.collectives import tp_all_gather, tp_all_reduce
    from ..distributed.ctx import gather_model
    bs, bc = cfg.zebra_block_seq, cfg.zebra_block_ch
    pending = []                        # (name, dims, itemsize, owned live)

    def one(path, leaf):
        name = "/".join(["kv", *map(str, path)])
        bd, sd, whole = CACHE_AXES[str(path[-1])]
        split = sd is not None and leaf.shape[sd] != getattr(cfg, whole)
        shape = list(leaf.shape)
        shape[bd] *= tp.data.size
        if split:
            shape[sd] *= tp.model.size
        dims = leaf_dims(tuple(shape), bs, bc)
        if dims is None:
            pending.append((name, None, leaf.element_size(), math.prod(shape)))
            return leaf
        nd = 1 if dims[1] == shape[-1] else 2
        # the model axis first: the batch's rows run over the heads or
        # channels inside them, as gathered
        gathers, owned = pack_plan(leaf.shape, ((tp.model, sd, split),
                                                (tp.data, bd, tp.data.size > 1)), nd, bs, bc)
        x, part = leaf, []
        for axis, dim in gathers:
            x = tp_all_gather(x, axis, dim) if axis is tp.data else gather_model(x, dim)
            n = leaf.shape[dim]
            part.append((dim % leaf.dim(), axis.index * n, n))
        cm = compress_map(x.reshape(-1, math.prod(x.shape[-nd:])), bs=bs, bc=bc,
                          checksum=checksum)
        cm = dataclasses.replace(cm, shape=tuple(x.shape), part=tuple(part) or None)
        pending.append((name, dims, leaf.element_size(),
                        cm.n_live.to(torch.int64) if owned else torch.zeros(
                            (), dtype=torch.int64, device=leaf.device)))
        return cm

    out = map_tree(one, caches)
    comp = [p for p in pending if p[1] is not None]
    if comp:
        lives = tp_all_reduce(torch.stack([p[3].reshape(()) for p in comp]), tp.world)
        lives = iter(lives.tolist())
    for name, dims, item, extra in pending:
        if dims is None:
            meter.record_dense(name, extra * item)
        else:
            meter.record_counts(name, m=dims[0], k=dims[1], bs=bs, bc=bc, itemsize=item,
                                n_live=next(lives))
    return out


def _leaves(tree) -> list:
    out = []
    map_tree(lambda _, leaf: out.append(leaf), tree)
    return out


def _map_leaves(fn, tree):
    """``map_tree`` with each leaf's index in ``_leaves`` order instead of
    its path."""
    count = itertools.count()
    return map_tree(lambda _, leaf: fn(next(count), leaf), tree)


def model_prefill_pad(prefill_fn, prompts: torch.Tensor, cache_len: int):
    """Prefill builds caches sized to the prompt; pad every attention cache
    (a leaf of four or more axes whose third from the end is the prompt
    length, the reference's rule: an SSD state (.., B, heads, state,
    head_dim) with as many heads as prompt tokens is padded too, as there) to
    ``cache_len`` bucketed up the power-of-two ladder
    (``serve.bucket.pow2_bucket``), as the reference does, so decode can
    run. End padding is position-correct: decode never attends past its
    position."""
    logits, (caches, enc_out), aux = prefill_fn(prompts)
    S = prompts.shape[1]
    pad = pow2_bucket(max(cache_len, S), lo=8) - S

    def padk(_, x):
        if x.dim() >= 4 and x.shape[-3] == S:      # (.., B, T, H, hd) attention caches
            widths = [0, 0] * x.dim()
            widths[2 * 2 + 1] = pad                 # the -3 axis, after
            return torch.nn.functional.pad(x, widths)
        return x
    return logits, (map_tree(padk, caches), enc_out), aux


if __name__ == "__main__":
    main()
