#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout and then:

1. prints the card's name and power limit (``nvidia-smi``);
2. holds each kernel bit for bit against its plain PyTorch version on the
   card: bf16, signed 8x128 token blocks, 2x2 and 4x4 blocks, an all-dead
   map and NaN/Inf inputs;
3. trains (``CNNTrainer.train``): ResNet-18 at full width on Tiny-ImageNet
   shapes (3x64x64, 200 classes), random weights from seed 0, batch 64,
   block 8, SGD with step decay from 0.05 and gradient clipping at 10,
   float32 with TF32 off, 5 steps in each of four runs:
   R  the ``reference`` backend at the constant T_obj 1.5 (the yardstick);
   B  the ``pallas`` backend at T_obj 1.5: the masking kernel forward, the
      hard-gate backward. Step 1's loss and every gradient, and the
      variables after 5 steps, must equal R's bit for bit; the masking
      kernel must launch 17 sites x 5 steps times;
   C  the ``stream`` backend at T_obj 1.5: the three stream kernels 17 x 5
      times each, the variables equal to R's, every site's stream bytes
      inside the Eq. 2/3 band;
   A  the paper's Eq. 1: threshold nets at T_obj 0.2 with their L2
      regulariser. The run asks for ``pallas`` and every site must resolve
      to ``reference(tnet)``, as the capability rules send a site with a
      net; the loss must stay finite and ``zebra_reg`` fall from step 1 to
      step 5;
4. drives the inference slice with B's trained variables:
   ``CNNTrainer.evaluate`` over 4 batches of 128 images on ``stream``
   (T_obj 1.5). Every stream kernel must have launched 17 sites x 4
   batches times; every site's stream bytes must lie in the Eq. 2/3 band;
   the logits must equal, bit for bit, a ``reference``-backend run;
5. checks each kernel against its plain version on the 17 site maps its
   path gives it (the stream kernels: the evaluate forward at batch 128;
   the masking kernel: B's train forward at batch 64) and times both with
   CUDA events, beside the kernel's byte bound at the card's memory rate;
6. prints one JSON line listing the kernels, the card line again, and
   ``{"ok": true, "device": ...}`` as the last line.

Any failed phase exits non-zero, and so does a host without CUDA or a
directory without the port beside this script. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory, NVIDIA data sheet
BATCHES, BATCH, T_OBJ, BLOCK = 4, 128, 1.5, 8
TRAIN_STEPS, TRAIN_BATCH, T_OBJ_TNET = 5, 64, 0.2
KERNELS = {
    # CUDA kernel: the Pallas kernel it replaces (_bitmap_kernel,
    # _gather_pack_kernel, _unpack_kernel, _zebra_mask_kernel)
    "zebra_bitmap_kernel": "src/repro/kernels/mask_pack.py:69",
    "zebra_pack_kernel": "src/repro/kernels/mask_pack.py:78",
    "zebra_unpack_kernel": "src/repro/kernels/pack.py:46",
    "zebra_mask_kernel": "src/repro/kernels/zebra_mask.py:24",
}
STREAM_KERNELS = ("zebra_bitmap_kernel", "zebra_pack_kernel", "zebra_unpack_kernel")
SOURCE = "src/repro_torch/kernels/csrc/zebra_stream.cu"


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# Kernel against plain version
# ---------------------------------------------------------------------------

def same_bits(a, b) -> bool:
    """Bit for bit, also for a tuple of tensors."""
    import torch
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_bits(u, v) for u, v in zip(a, b))
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
        a, b = a.view(ints), b.view(ints)
    return bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    import torch
    if isinstance(a, tuple):
        return max(max_abs_err(u, v) for u, v in zip(a, b))
    d = (a.double() - b.double()).abs()
    return float(torch.nan_to_num(d, nan=0.0, posinf=0.0).max()) if d.numel() else 0.0


def stream_pieces(x, t_obj, bs, bc):
    """The plain upstream of each kernel: bitmap, slot map, n_live, payload."""
    import torch
    from repro_torch.kernels import mask_pack
    from repro_torch.kernels.schedule import slot_map
    bitmap = mask_pack.bitmap_plain(x, t_obj, bs, bc)
    keep, slot = slot_map(bitmap)
    n_live = keep.sum(dtype=torch.int32)
    payload = mask_pack.pack_plain(x, bitmap, slot, n_live, bs, bc)
    return bitmap, keep, slot, n_live, payload


def kernel_calls(x, t_obj, bs, bc, names=tuple(KERNELS)):
    """{kernel: (kernel call, plain call)} on one map for the named
    kernels, each fed the plain version's upstream, so each kernel is
    checked on its own; and the map's live block count."""
    from repro_torch.kernels import mask_pack, pack, zebra_mask
    bitmap, keep, slot, n_live, payload = stream_pieces(x, t_obj, bs, bc)
    nm, nk = bitmap.shape
    calls = {
        "zebra_bitmap_kernel": (lambda: mask_pack.bitmap_cuda(x, t_obj, bs, bc),
                                lambda: mask_pack.bitmap_plain(x, t_obj, bs, bc)),
        "zebra_pack_kernel": (lambda: mask_pack.pack_cuda(x, bitmap, slot, n_live, bs, bc),
                              lambda: mask_pack.pack_plain(x, bitmap, slot, n_live, bs, bc)),
        "zebra_unpack_kernel": (lambda: pack.unpack_cuda(payload, bitmap, slot, bs, bc),
                                lambda: pack.expand_payload(payload, keep, slot, nm, nk,
                                                            bs, bc)),
        "zebra_mask_kernel": (lambda: zebra_mask.mask_cuda(x, t_obj, bs, bc),
                              lambda: zebra_mask.mask_plain(x, t_obj, bs, bc)),
    }
    return {k: calls[k] for k in names}, int(n_live)


def compare_kernels(x, t_obj, bs, bc, label: str, names=tuple(KERNELS)) -> dict[str, float]:
    """Each kernel bit for bit against its plain version; returns the max
    abs error per kernel (0.0 when the bits agree)."""
    import torch
    calls, _ = kernel_calls(x, t_obj, bs, bc, names)
    errs = {}
    for name, (kern, plain) in calls.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        check(same_bits(got, want), f"{name} differs from its plain version on {label} "
                                    f"(max abs err {max_abs_err(got, want)})")
        errs[name] = max_abs_err(got, want)
    return errs


def synthetic_map(M, K, bs, bc, dtype, signed, seed, device):
    import torch
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=g)
    x = (x.reshape(M // bs, bs, K // bc, bc)
         * torch.rand(M // bs, 1, K // bc, 1, generator=g) * 3.0).reshape(M, K)
    if not signed:
        x = x.clamp_min(0.0)
    return x.to(dtype).to(device)


def edge_cases(device) -> None:
    import torch
    cases = {
        # label: (M, K, bs, bc, dtype, signed, t_obj)
        "bf16 8x8": (65536, 64, 8, 8, torch.bfloat16, False, T_OBJ),
        "8x128 token blocks f32": (4096, 2048, 8, 128, torch.float32, True, 0.5),
        "8x128 token blocks bf16": (4096, 2048, 8, 128, torch.bfloat16, True, 0.5),
        "2x2 blocks (b=2)": (65536, 8, 2, 2, torch.float32, False, 1.0),
        "4x4 blocks": (65536, 16, 4, 4, torch.float32, False, 1.0),
        "all-dead": (65536, 64, 8, 8, torch.float32, False, 1e9),
    }
    for i, (label, (M, K, bs, bc, dtype, signed, t)) in enumerate(cases.items()):
        compare_kernels(synthetic_map(M, K, bs, bc, dtype, signed, i, device), t, bs, bc,
                        label)
        print(f"  kernels == plain (bitwise): {label} ({M}x{K}, block {bs}x{bc})")
    x = synthetic_map(65536, 64, 8, 8, torch.float32, False, 99, device)
    x[1, 2] = float("nan")          # a block holding NaN is dead
    x[9, 17] = float("inf")         # a block holding Inf is live
    x[17, 40] = float("-inf")
    bitmap = stream_pieces(x, T_OBJ, 8, 8)[0]
    check(int(bitmap[0, 0]) == 0 and int(bitmap[1, 2]) == 1 and int(bitmap[2, 5]) == 1,
          "NaN/Inf blocks not resolved as the reference resolves them")
    compare_kernels(x, T_OBJ, 8, 8, "NaN/Inf")
    print("  kernels == plain (bitwise): NaN/Inf (65536x64, block 8x8)")
    # the masking kernel multiplies: dead negative values give -0.0, a dead
    # NaN block stays NaN
    from repro_torch.kernels.zebra_mask import mask_cuda
    y = mask_cuda(synthetic_map(4096, 2048, 8, 128, torch.float32, True, 5, device),
                  0.5, 8, 128)[0]
    check(bool((y.view(torch.int32) == -2 ** 31).any()), "no -0.0 in dead signed blocks")
    check(bool(torch.isnan(mask_cuda(x, T_OBJ, 8, 8)[0][1, 2])), "dead NaN block lost its NaN")


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def time_ms(fn, flush, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around each call, with
    the 50 MB L2 cache flushed before each (the site's map was written by
    the layer before it, and most maps exceed L2)."""
    import torch
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound_bytes(name: str, M: int, K: int, bs: int, bc: int, item: int, n_live: int) -> int:
    """Bytes the function must move on this input: each input read once,
    each output written once. Only live blocks of x (pack) or of the
    payload (unpack) need reading, and only their int32 slot entries; the
    int8 bitmap is read whole."""
    nb = (M // bs) * (K // bc)
    blk = bs * bc * item
    if name == "zebra_bitmap_kernel":
        return M * K * item + nb
    if name == "zebra_mask_kernel":                # map read, masked map + bitmap written
        return 2 * M * K * item + nb
    live_in = n_live * blk + nb + n_live * 4       # live blocks, bitmap, live slots
    if name == "zebra_pack_kernel":
        return live_in + 4 + nb * blk              # + n_live, whole payload written
    return live_in + M * K * item                  # + dense map written


# ---------------------------------------------------------------------------
# The slice
# ---------------------------------------------------------------------------

def launch_counts() -> dict[str, int]:
    from repro_torch.kernels import launch_counters
    return {k: w.launches for k, w in launch_counters().items()}


def check_launches(launches, want: dict[str, int], label: str) -> None:
    """Each kernel launched exactly as often as ``want`` says (0 if absent)."""
    print(f"  launches ({label}): {launches}")
    for name, n in launches.items():
        check(n == want.get(name, 0), f"{label}: {name} launched {n} times, "
                                      f"want {want.get(name, 0)}")


def check_band(records, label: str) -> float:
    """Every site's stream bytes inside the Eq. 2/3 index-padding band;
    ``records`` holds (map shape, block, element size, SiteAux)."""
    from repro_torch.core import MapSpec, stored_bits
    worst = 0.0
    for i, (shape, b, item, aux) in enumerate(records):
        B, C, H, W = shape
        spec = MapSpec(c=B * C, h=H, w=W, bits=8 * item, block=b)
        predicted = stored_bits(spec, float(aux.zero_frac)) / 8.0
        delta = int(aux.measured_bytes) - predicted
        worst = max(worst, abs(delta))
        check(0.0 <= delta < 1.0, f"{label} site {i}: measured {int(aux.measured_bytes)} "
                                   f"B vs Eq. 2/3 {predicted} B: outside the band")
    return worst


class SiteRecorder:
    """Wraps the engine entry the model's sites call and records each
    site's map shape, block, element size and SiteAux (and, when
    ``keep_maps``, a copy of its input map). Adds no kernel launch."""

    def __init__(self, keep_maps: bool = False):
        self.keep_maps = keep_maps
        self.records, self.maps = [], []

    def __enter__(self):
        import repro_torch.models.cnn.common as common
        self._common, self._inner = common, common.zebra_site

        def site(x, cfg, **kw):
            if self.keep_maps:
                self.maps.append((x.detach().contiguous().clone(), cfg.block_hw))
            y, aux = self._inner(x, cfg, **kw)
            self.records.append((tuple(x.shape), cfg.block_hw, x.element_size(), aux))
            return y, aux
        common.zebra_site = site
        return self

    def __exit__(self, *exc):
        self._common.zebra_site = self._inner


def run_slice(device, variables=None, batches=BATCHES, batch=BATCH, width_mult=1.0):
    """Drive ResNet-18 inference through CNNTrainer.evaluate on `stream`
    (``variables``: the trained ones, else fresh random weights); return
    the stream kernels' launches and the site maps of one forward."""
    import torch
    from repro_torch.core import ZebraConfig
    from repro_torch.data import SYN_TINYIMAGENET, image_batch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.train import CNNTrainConfig, CNNTrainer

    zcfg = ZebraConfig(mode="infer", backend="stream", block_hw=BLOCK, t_obj=T_OBJ,
                       use_tnet=False)
    cfg = CNNTrainConfig(model="resnet18", width_mult=width_mult,
                         dataset=SYN_TINYIMAGENET, zebra=zcfg, seed=0)
    trainer = CNNTrainer(cfg, device=device)
    variables = variables or trainer.init_state()["variables"]
    n_sites = len(trainer.model.map_specs(cfg.dataset.hw, zcfg))

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = trainer.evaluate(variables, batches=batches, batch=batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    print(f"slice: {batches} x {batch} images in {wall:.3f} s "
          f"({batches * batch / wall:.1f} images/s end to end, host data included)")
    check_launches(launches, {k: n_sites * batches for k in STREAM_KERNELS}, "evaluate")
    dense = sum(s.elems * 4 for s in trainer.model.map_specs(cfg.dataset.hw, zcfg))
    print(f"  acc {out['acc']} top5 {out['top5']} zero_frac {out['zero_frac']} "
          f"reduced_bandwidth_pct {out['reduced_bandwidth_pct']}")
    print(f"  stream bytes per image {out['measured_bytes'] / batch} vs dense float32 "
          f"{dense} (per batch: {out['measured_bytes_per_batch']})")
    check(0.0 < out["zero_frac"] < 1.0, f"zero_frac {out['zero_frac']} out of (0, 1)")

    # one more batch, recording every site's input map
    images, _ = image_batch(cfg.dataset, batch, 10_000)
    images = torch.from_numpy(images).to(device)
    with SiteRecorder(keep_maps=True) as rec:
        logits, _ = trainer.forward(variables, images)
    maps = rec.maps
    check(len(maps) == n_sites, f"{len(maps)} site maps recorded, want {n_sites}")
    check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (batch, 200),
          f"logits not finite of shape ({batch}, 200)")
    worst = check_band(rec.records, "evaluate")
    print(f"  every site inside the Eq. 2/3 band (worst |delta| {worst} B)")

    ref_logits, _ = trainer.forward(variables, images, zcfg.replace(backend="reference"))
    check(same_bits(logits, ref_logits), "stream logits differ from reference logits")
    print("  logits: stream == reference (bitwise)")

    fwd = {}
    for backend in ("stream", "reference"):
        z = zcfg.replace(backend=backend)
        trainer.forward(variables, images, z)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            trainer.forward(variables, images, z)
        torch.cuda.synchronize()
        fwd[backend] = (time.perf_counter() - t0) / 5 * 1e3
    print(f"  forward of one batch of {batch}: stream {fwd['stream']:.3f} ms, "
          f"reference {fwd['reference']:.3f} ms (host clock, synchronised)")
    for backend in ("stream", "reference"):
        profile_forward(trainer, variables, images, zcfg.replace(backend=backend))
    return launches, maps


def profile_forward(trainer, variables, images, zcfg, n: int = 3) -> None:
    profile_calls(lambda: trainer.forward(variables, images, zcfg), n,
                  f"{zcfg.backend} forwards", "forward")


def profile_calls(fn, n: int, what: str, unit: str) -> float | None:
    """Device kernel time by kernel over n calls of fn (torch.profiler),
    and the device's busy share of the profiled window's wall time.
    Returns the busy ms per call (None when the profiler saw no device)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        print(f"  profile ({what}): no device time recorded (not measured)")
        return None
    print(f"  profile of {n} {what}: device busy {busy_ms / n:.3f} ms per {unit}, "
          f"{100 * busy_ms / wall_ms:.1f} % of the profiled wall time "
          f"({wall_ms / n:.3f} ms per {unit} under the profiler)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / n / 1e3:8.3f} ms  {e.count // n:4d} calls  "
              f"{e.key[:100]}")
    return busy_ms / n


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def run_training(device, steps=TRAIN_STEPS, batch=TRAIN_BATCH, width_mult=1.0):
    """The four training runs R, B, C, A (module docstring). Returns B's
    trained variables, the launch counts read after B's run, and the site
    maps of one B train forward."""
    import torch
    from repro_torch.core import ZebraConfig
    from repro_torch.data import SYN_TINYIMAGENET, StreamingLoader, image_batch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.optim import sgd, step_decay
    from repro_torch.train import CNNTrainConfig, CNNTrainer

    # the batches go to the card first, so the step times hold no data generation
    batches = [tuple(torch.from_numpy(a).to(device)
                     for a in image_batch(SYN_TINYIMAGENET, batch, i)) for i in range(steps)]

    def trainer(**zkw):
        cfg = CNNTrainConfig(model="resnet18", width_mult=width_mult,
                             dataset=SYN_TINYIMAGENET, batch=batch, steps=steps,
                             zebra=ZebraConfig(block_hw=BLOCK, **zkw), grad_clip=10.0,
                             seed=0)
        return CNNTrainer(cfg, sgd(step_decay(0.05, total_steps=steps)), device=device)

    def loader():
        return StreamingLoader(lambda b, step: batches[step], batch)

    def train(tr, label, want):
        """``CNNTrainer.train`` for ``steps`` steps, the launch counts set
        to 0 just before and read just after. Returns ``(state, history,
        launch counts)``."""
        stamps = []
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, hist = tr.train(steps, log_every=1, loader=loader(),
                               callback=lambda m: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        counts = launch_counts()
        check_launches(counts, want, label)
        ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps[:-1], stamps)]
        rest = sum(ms[1:]) / len(ms[1:])
        print(f"  {label}: step 1 {ms[0]:.3f} ms, steps 2-{steps} {rest:.3f} ms per step "
              f"({batch / rest * 1e3:.1f} images/s; host clock, synchronised)")
        print(f"    loss {[m['loss'] for m in hist]}")
        print(f"    zebra_reg {[m['zebra_reg'] for m in hist]}")
        print(f"    zero_frac {[m['zero_frac'] for m in hist]} "
              f"measured_bytes {[m['measured_bytes'] for m in hist]}")
        check(all(math.isfinite(m["loss"]) for m in hist), f"{label}: loss not finite")
        busy = profile_calls(lambda: tr._step(state, *batches[0]), 2, f"{label} steps",
                             "step")
        if busy is not None:
            print(f"  {label}: device busy {100 * busy / rest:.1f} % of an unprofiled step "
                  f"({busy:.3f} of {rest:.3f} ms)")
        return state, hist, counts

    kw = dict(t_obj=T_OBJ, use_tnet=False)
    R = trainer(backend="reference", **kw)
    B = trainer(backend="pallas", **kw)
    C = trainer(backend="stream", **kw)
    n_sites = len(R.model.map_specs(SYN_TINYIMAGENET.hw, R.cfg.zebra))
    per_run = n_sites * steps
    print(f"training: ResNet-18 width {width_mult}, batch {batch}, {steps} steps per run")

    # B's first step against R's, bit for bit, before either trains
    _, loss_r, grads_r, _, _ = R.loss_and_grads(R.init_state(), *batches[0])
    _, loss_b, grads_b, _, _ = B.loss_and_grads(B.init_state(), *batches[0])
    check(same_bits(loss_b, loss_r), f"step-1 loss: pallas {float(loss_b)} vs reference "
                                     f"{float(loss_r)}")
    for k in grads_r:
        check(same_bits(grads_b[k], grads_r[k]),
              f"step-1 gradient {k}: pallas differs from reference "
              f"(max abs err {max_abs_err(grads_b[k], grads_r[k])})")
    print(f"  step 1: pallas loss and all {len(grads_r)} gradients == reference (bitwise)")
    del grads_r, grads_b

    state_r, *_ = train(R, "R reference T_obj 1.5", {})
    state_b, _, counts_b = train(B, "B pallas T_obj 1.5", {"zebra_mask_kernel": per_run})
    with SiteRecorder() as rec:
        state_c, *_ = train(C, "C stream T_obj 1.5", {k: per_run for k in STREAM_KERNELS})
    check(len(rec.records) >= per_run, f"{len(rec.records)} site records in C")
    worst = check_band(rec.records, "C stream train")
    print(f"  C: every site of every step inside the Eq. 2/3 band (worst |delta| {worst} B)")
    for label, st in (("B pallas", state_b), ("C stream", state_c)):
        for k, v in state_r["variables"].items():
            check(same_bits(st["variables"][k], v),
                  f"{label} after {steps} steps: {k} differs from the reference run")
        print(f"  {label}: all {len(state_r['variables'])} variables after {steps} steps "
              f"== reference run (bitwise)")
    del state_r, state_c, R, C

    A = trainer(backend="pallas", t_obj=T_OBJ_TNET, use_tnet=True)
    with SiteRecorder() as rec:
        _, hist_a, _ = train(A, "A tnet Eq. 1 T_obj 0.2", {})
    labels = {aux.backend for *_, aux in rec.records}
    check(labels == {"reference(tnet)"}, f"A: site backends {labels}")
    check(hist_a[-1]["zebra_reg"] < hist_a[0]["zebra_reg"],
          f"A: zebra_reg did not fall ({hist_a[0]['zebra_reg']} -> {hist_a[-1]['zebra_reg']})")
    print(f"  A: every site ran reference(tnet); zebra_reg {hist_a[0]['zebra_reg']} -> "
          f"{hist_a[-1]['zebra_reg']}")
    del A

    with SiteRecorder(keep_maps=True) as rec:
        B.loss_and_grads(state_b, *batches[0])
    check(len(rec.maps) == n_sites, f"{len(rec.maps)} B site maps, want {n_sites}")
    return state_b["variables"], counts_b, rec.maps


def time_kernels(groups, device) -> list[dict]:
    """``groups``: (kernel names, site maps, launches on the main path).
    Each kernel is held against its plain version on its maps and timed."""
    import torch
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=device)   # 256 MB
    rows = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
            for k in KERNELS}
    launches, by_shape = {}, {}
    for names, maps, group_launches in groups:
        launches.update({k: group_launches[k] for k in names})
        for x4, b in maps:
            B, C, H, W = x4.shape
            x = x4.reshape(B * C * H, W)
            errs = compare_kernels(x, T_OBJ, b, b, f"site map {tuple(x4.shape)}", names)
            calls, n_live = kernel_calls(x, T_OBJ, b, b, names)
            for name, (kern, plain) in calls.items():
                ms, pms = time_ms(kern, flush), time_ms(plain, flush)
                bound = bound_bytes(name, *x.shape, b, b, x.element_size(), n_live) \
                    / HBM_BYTES_PER_S * 1e3
                r = rows[name]
                r["ms"] += ms
                r["plain_ms"] += pms
                r["bound_ms"] += bound
                r["max_abs_err"] = max(r["max_abs_err"], errs[name])
                by_shape.setdefault((name, tuple(x.shape)), []).append((ms, pms, bound))
    print("kernel times per site shape (mean over sites; CUDA events, L2 flushed):")
    for (name, shape), vals in sorted(by_shape.items()):
        n = len(vals)
        ms, pms, bound = (sum(v[i] for v in vals) / n for i in range(3))
        print(f"  {name:22s} M,K={shape}: {ms:.4f} ms  plain {pms:.4f} ms  "
              f"bound {bound:.4f} ms  ({n} sites)")
    return [{"name": name, "route": "cuda", "source": SOURCE, "replaces": KERNELS[name],
             "launches": launches[name], "max_abs_err": rows[name]["max_abs_err"],
             "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
             "bound_ms": rows[name]["bound_ms"], "bound_by": "bytes", "library_ms": None}
            for name in KERNELS]


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run it from "
              "the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 2
    try:
        card = card_line()
        print(f"card: {card}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        # bitwise stream-vs-reference logits need one convolution algorithm
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

        from repro_torch.kernels import build
        t0 = time.perf_counter()
        build.load_library()
        print(f"build: {time.perf_counter() - t0:.1f} s into {build.build_dir()}")
        for log in sorted(build.build_dir().glob("*.log")):
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"  ptxas: {line.strip()}")

        print("kernels vs plain versions on the card:")
        edge_cases(device)
        trained, train_launches, mask_maps = run_training(device)
        launches, maps = run_slice(device, trained)
        kernels = time_kernels(
            [(STREAM_KERNELS, maps, launches),
             (("zebra_mask_kernel",), mask_maps, train_launches)],
            device)
        print(json.dumps({"kernels": kernels}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
