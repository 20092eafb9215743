"""Time the comparator (``zebra_bitmap_kernel``) and the masking kernel
(``zebra_mask_kernel``) on maps of the shapes the port's paths give them,
on one card::

    PYTHONPATH=src python src/repro_torch/kernels/stream_timing.py [--label NAME] [--out FILE]

With ``PYTHONPATH`` at another checkout's ``src`` the same script times
that checkout's kernels (it calls only ``mask_pack.bitmap_cuda`` and
``zebra_mask.mask_cuda``), so two versions can be timed in turns in one
call on one card.

The maps are synthetic, from seed 0, of the shapes and dtypes of the paths
(a kernel reads every element whatever it holds, so its time depends on the
shape, not on the values):

- CNN evaluate, batch 128: the comparator on ResNet-18's 17 site maps,
  float32 (524288, W) for W = 8, 16, 32 (4 sites each) and 64 (5 sites),
  8 x 8 blocks, T_obj 1.5;
- CNN training step, batch 64: the masking kernel on the same sites at
  (262144, W);
- gemma3-4b prefill: the comparator on 34 ``ffn_hidden`` maps (4096,
  10240) bfloat16 and the masking kernel on 68 ``kv_cache`` maps (4096,
  1280) bfloat16, 8 x 128 blocks, T_obj 1.05.

Each distinct shape is timed once with CUDA events, the 50 MB L2 cache
flushed before each launch, and counted as often as the path launches it.
The flush ``chip_smoke.py`` uses writes a 256 MB buffer, so it leaves L2
full of dirty lines that the timed launch's misses must write back; the
"clean" time flushes by reading the buffer instead (an ablation of the
measurement, not of the kernel). Beside each kernel: its byte bound (the
map read once and the int8 bitmap written, plus the masked map written
for the masking kernel, at 3.35 TB/s), and library passes over the same
bytes as yardsticks of what a tuned streaming kernel reaches on the card
(none computes the kernel's function): ``torch.amax`` of the map viewed
as (nm, bs, nk, bc) over the block axes, ``torch.amax`` of the whole map
(one flat read), and, for the masking kernel, ``copy_`` of the map into a
map of its shape. Last, the host time of one wrapper call, from the
Python call to the launch: the wall time per call over 500 calls on a
(64, 64) map, which the card finishes faster than the host enqueues it.
Prints one line per row and writes them as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory, NVIDIA data sheet
ENQUEUE_SLACK_CYCLES = 200_000  # device spin before each timed call, ~0.1 ms
CNN_WIDTHS = {8: 4, 16: 4, 32: 4, 64: 5}          # site map width: sites
# row: (kernel, [(M, K, sites)], bs, bc, dtype, T_obj)
ROWS = {
    "CNN evaluate, batch 128": ("bitmap", [(524288, w, n) for w, n in CNN_WIDTHS.items()],
                                8, 8, torch.float32, 1.5),
    "CNN training step, batch 64": ("mask", [(262144, w, n) for w, n in CNN_WIDTHS.items()],
                                    8, 8, torch.float32, 1.5),
    "gemma3-4b prefill, ffn_hidden": ("bitmap", [(4096, 10240, 34)], 8, 128,
                                      torch.bfloat16, 1.05),
    "gemma3-4b prefill, kv_cache": ("mask", [(4096, 1280, 68)], 8, 128, torch.bfloat16,
                                    1.05),
}


def time_ms(fn, flush, iters: int = 20, warmup: int = 3, clean: bool = False) -> float:
    """Mean device time of one call (CUDA events, L2 flushed before each by
    writing ``flush``, or by reading it when ``clean``). The device spins
    ~0.1 ms after the flush, so the call is enqueued before the start event
    runs and the host's time never falls between the events."""
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        if clean:
            flush.max()
        else:
            flush.zero_()
        torch.cuda._sleep(ENQUEUE_SLACK_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def site_map(M, K, bs, bc, dtype, device, seed=0):
    """A map whose blocks are scaled so that some fall under T_obj."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(M // bs, bs, K // bc, bc, generator=g, device=device)
    x *= torch.rand(M // bs, 1, K // bc, 1, generator=g, device=device) * 3.0
    return x.reshape(M, K).to(dtype)


def time_row(kernel, shapes, bs, bc, dtype, t_obj, flush, device) -> dict:
    from repro_torch.kernels import mask_pack, zebra_mask
    out = {"kernel": f"zebra_{kernel}_kernel", "launches": 0, "ms": 0.0, "clean_ms": 0.0,
           "bound_ms": 0.0, "amax_ms": 0.0, "flat_amax_ms": 0.0,
           "copy_ms": 0.0 if kernel == "mask" else None, "shapes": []}
    for M, K, n in shapes:
        x = site_map(M, K, bs, bc, dtype, device)
        nb = (M // bs) * (K // bc)
        item = x.element_size()
        if kernel == "bitmap":
            def run():
                return mask_pack.bitmap_cuda(x, t_obj, bs, bc)
            nbytes = M * K * item + nb
        else:
            def run():
                return zebra_mask.mask_cuda(x, t_obj, bs, bc)
            nbytes = 2 * M * K * item + nb
            y = torch.empty_like(x)
            out["copy_ms"] += n * time_ms(lambda: y.copy_(x), flush)
        ms, clean = time_ms(run, flush), time_ms(run, flush, clean=True)
        view = x.view(M // bs, bs, K // bc, bc)
        amax = time_ms(lambda: torch.amax(view, dim=(1, 3)), flush)
        flat = time_ms(lambda: torch.amax(x), flush)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        out["launches"] += n
        for key, v in (("ms", ms), ("clean_ms", clean), ("bound_ms", bound),
                       ("amax_ms", amax), ("flat_amax_ms", flat)):
            out[key] += n * v
        out["shapes"].append({"M": M, "K": K, "sites": n, "ms": ms, "clean_ms": clean,
                              "bound_ms": bound, "amax_ms": amax, "flat_amax_ms": flat,
                              "GB_per_s": nbytes / ms / 1e6,
                              "clean_GB_per_s": nbytes / clean / 1e6})
        del x
    return out


def host_us(fn, calls: int = 500) -> float:
    """Wall time per call of ``fn`` over ``calls`` calls in a row, in µs."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stream_timing: needs a CUDA card")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=device)   # 256 MB
    rows = {}
    for name, (kernel, shapes, bs, bc, dtype, t_obj) in ROWS.items():
        r = rows[name] = time_row(kernel, shapes, bs, bc, dtype, t_obj, flush, device)
        copy = "" if r["copy_ms"] is None else f", copy_ {r['copy_ms']:.4f} ms"
        print(f"{args.label}: {name}: {r['kernel']} x {r['launches']}: {r['ms']:.4f} ms "
              f"(clean L2 {r['clean_ms']:.4f}), bound {r['bound_ms']:.4f} ms "
              f"({r['ms'] / r['bound_ms']:.2f}x); amax {r['amax_ms']:.4f} ms, flat amax "
              f"{r['flat_amax_ms']:.4f} ms{copy}")
        for s in r["shapes"]:
            print(f"    ({s['M']}, {s['K']}) x {s['sites']}: {s['ms']:.4f} ms per launch, "
                  f"{s['GB_per_s']:.0f} GB/s (clean L2 {s['clean_ms']:.4f} ms, "
                  f"{s['clean_GB_per_s']:.0f} GB/s); amax {s['amax_ms']:.4f} ms, flat amax "
                  f"{s['flat_amax_ms']:.4f} ms")
    from repro_torch.kernels import mask_pack, zebra_mask
    tiny = site_map(64, 64, 8, 8, torch.float32, device)
    host = {"zebra_bitmap_kernel": host_us(lambda: mask_pack.bitmap_cuda(tiny, 1.5, 8, 8)),
            "zebra_mask_kernel": host_us(lambda: zebra_mask.mask_cuda(tiny, 1.5, 8, 8))}
    print(f"{args.label}: host time per wrapper call (64x64 map): "
          + ", ".join(f"{k} {v:.1f} us" for k, v in host.items()))
    print(f"{args.label}: card {card}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"label": args.label, "card": card, "rows": rows,
                       "host_us_per_call": host}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
