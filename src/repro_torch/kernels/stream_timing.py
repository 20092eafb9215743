"""Time the four stream kernels — the comparator (``zebra_bitmap_kernel``),
the masking kernel (``zebra_mask_kernel``), pack (``zebra_pack_kernel``)
and the expander (``zebra_unpack_kernel``) — on maps of the shapes the
port's paths give them, on one card::

    PYTHONPATH=src python src/repro_torch/kernels/stream_timing.py [--label NAME] [--out FILE]

With ``PYTHONPATH`` at another checkout's ``src`` the same script times
that checkout's kernels (it calls only ``mask_pack.bitmap_cuda``,
``zebra_mask.mask_cuda``, ``mask_pack.pack_cuda`` and
``pack.unpack_cuda``, and makes every other input with the plain versions
and ``schedule.slot_map``), so two versions can be timed in turns in one
call on one card.

The maps are synthetic, from seed 0, of the shapes and dtypes of the paths:

- CNN evaluate, batch 128: the comparator, pack and the expander on
  ResNet-18's 17 site maps, float32 (524288, W) for W = 8, 16, 32 (4 sites
  each) and 64 (5 sites), 8 x 8 blocks;
- CNN training step, batch 64: the masking kernel on the same sites at
  (262144, W);
- gemma3-4b prefill: the comparator and pack on 34 ``ffn_hidden`` maps
  (4096, 10240) bfloat16 and the masking kernel on 68 ``kv_cache`` maps
  (4096, 1280) bfloat16, 8 x 128 blocks.

The comparator and the masking kernel read every element whatever it
holds, so their rows keep the path's T_obj (1.5 on the CNN maps, 1.05 on
the LM ones). Pack and unpack read only the live blocks, so their time
depends on the zero fraction: their rows set T_obj per map to the block-max
quantile that gives the path's zero fraction (0.669 on ``ffn_hidden`` at
T_obj 1.05 on random weights; 0.68 on the CNN evaluate maps, their
block-weighted zero fraction at T_obj 1.5 as the pack bound of the
recorded maps gives it) and print the fraction reached.

Each distinct shape is timed once with CUDA events, the 50 MB L2 cache
flushed before each launch, and counted as often as the path launches it.
The flush ``chip_smoke.py`` uses writes a 256 MB buffer, so it leaves L2
full of dirty lines that the timed launch's misses must write back; the
"clean" time flushes by reading the buffer instead (an ablation of the
measurement, not of the kernel). Beside each kernel: its byte bound
(``bound_bytes``, at 3.35 TB/s), and library passes over the same order of
bytes as yardsticks of what a tuned streaming kernel reaches on the card
(none computes the kernel's function): for the comparator and the masking
kernel ``torch.amax`` of the map viewed as (nm, bs, nk, bc) over the block
axes and ``torch.amax`` of the whole map (one flat read); for the masking
kernel, pack and unpack ``copy_`` of the map into a map of its shape. Last,
the host time of one wrapper call, from the Python call to the launch: the
wall time per call over 500 calls on a (64, 64) map, which the card
finishes faster than the host enqueues it. Prints one line per row and
writes them as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import NamedTuple

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory, NVIDIA data sheet
ENQUEUE_SLACK_CYCLES = 200_000  # device spin before each timed call, ~0.1 ms
CNN_WIDTHS = {8: 4, 16: 4, 32: 4, 64: 5}          # site map width: sites


class Row(NamedTuple):
    kernel: str                 # bitmap, mask, pack or unpack
    shapes: list                # [(M, K, sites)]
    bs: int
    bc: int
    dtype: torch.dtype
    t_obj: float | None         # the path's T_obj, or
    zero_frac: float | None = None   # the path's zero fraction (pack, unpack)


_CNN_EVAL = [(524288, w, n) for w, n in CNN_WIDTHS.items()]
_FFN = [(4096, 10240, 34)]
ROWS = {
    "CNN evaluate, batch 128": Row("bitmap", _CNN_EVAL, 8, 8, torch.float32, 1.5),
    "CNN training step, batch 64": Row("mask", [(262144, w, n) for w, n in CNN_WIDTHS.items()],
                                       8, 8, torch.float32, 1.5),
    "gemma3-4b prefill, ffn_hidden": Row("bitmap", _FFN, 8, 128, torch.bfloat16, 1.05),
    "gemma3-4b prefill, kv_cache": Row("mask", [(4096, 1280, 68)], 8, 128, torch.bfloat16,
                                       1.05),
    "CNN evaluate, batch 128, pack": Row("pack", _CNN_EVAL, 8, 8, torch.float32, None, 0.68),
    "CNN evaluate, batch 128, unpack": Row("unpack", _CNN_EVAL, 8, 8, torch.float32, None,
                                           0.68),
    "gemma3-4b prefill, ffn_hidden, pack": Row("pack", _FFN, 8, 128, torch.bfloat16, None,
                                               0.669),
}


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


def kernel_call(row: Row, x):
    """The row's kernel call on map x, its inputs made by the plain
    versions; and the map's live block count (None: not read)."""
    from repro_torch.kernels import mask_pack, pack, zebra_mask
    from repro_torch.kernels.schedule import slot_map
    bs, bc = row.bs, row.bc
    if row.kernel == "bitmap":
        return (lambda: mask_pack.bitmap_cuda(x, row.t_obj, bs, bc)), None
    if row.kernel == "mask":
        return (lambda: zebra_mask.mask_cuda(x, row.t_obj, bs, bc)), None
    blockmax = x.view(x.shape[0] // bs, bs, x.shape[1] // bc, bc).abs().amax(dim=(1, 3))
    t_obj = float(torch.quantile(blockmax.float().flatten(), row.zero_frac))
    bitmap = mask_pack.bitmap_plain(x, t_obj, bs, bc)
    keep, slot = slot_map(bitmap)
    n_live = keep.sum(dtype=torch.int32)
    if row.kernel == "pack":
        return (lambda: mask_pack.pack_cuda(x, bitmap, slot, n_live, bs, bc)), int(n_live)
    payload = mask_pack.pack_plain(x, bitmap, slot, n_live, bs, bc)
    return (lambda: pack.unpack_cuda(payload, bitmap, slot, bs, bc)), int(n_live)


def time_row(row: Row, flush, device) -> dict:
    name = f"zebra_{row.kernel}_kernel"
    amax = row.kernel in ("bitmap", "mask")
    out = {"kernel": name, "launches": 0, "ms": 0.0, "clean_ms": 0.0, "bound_ms": 0.0,
           "amax_ms": 0.0 if amax else None, "flat_amax_ms": 0.0 if amax else None,
           "copy_ms": None if row.kernel == "bitmap" else 0.0, "live_blocks": 0,
           "blocks": 0, "shapes": []}
    for M, K, n in row.shapes:
        x = site_map(M, K, row.bs, row.bc, row.dtype, device)
        run, n_live = kernel_call(row, x)
        nb = (M // row.bs) * (K // row.bc)
        nbytes = bound_bytes(name, M, K, row.bs, row.bc, x.element_size(), n_live or 0)
        ms, clean = time_ms(run, flush), time_ms(run, flush, clean=True)
        s = {"M": M, "K": K, "sites": n, "ms": ms, "clean_ms": clean,
             "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "GB_per_s": nbytes / ms / 1e6,
             "clean_GB_per_s": nbytes / clean / 1e6}
        if amax:
            view = x.view(M // row.bs, row.bs, K // row.bc, row.bc)
            s["amax_ms"] = time_ms(lambda: torch.amax(view, dim=(1, 3)), flush)
            s["flat_amax_ms"] = time_ms(lambda: torch.amax(x), flush)
        if out["copy_ms"] is not None:
            y = torch.empty_like(x)
            s["copy_ms"] = time_ms(lambda: y.copy_(x), flush)
        if n_live is not None:
            s["zero_frac"] = 1.0 - n_live / nb
            out["live_blocks"] += n * n_live
            out["blocks"] += n * nb
        out["launches"] += n
        for key in ("ms", "clean_ms", "bound_ms", "amax_ms", "flat_amax_ms", "copy_ms"):
            if out[key] is not None:
                out[key] += n * s[key]
        out["shapes"].append(s)
        del x, run
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
    for name, row in ROWS.items():
        r = rows[name] = time_row(row, flush, device)
        yards = "".join(f", {k[:-3]} {r[k]:.4f} ms" for k in ("amax_ms", "flat_amax_ms",
                                                               "copy_ms") if r[k] is not None)
        zf = f", zero fraction {1 - r['live_blocks'] / r['blocks']:.4f}" if r["blocks"] else ""
        print(f"{args.label}: {name}: {r['kernel']} x {r['launches']}: {r['ms']:.4f} ms "
              f"(clean L2 {r['clean_ms']:.4f}), bound {r['bound_ms']:.4f} ms "
              f"({r['ms'] / r['bound_ms']:.2f}x){yards}{zf}")
        for s in r["shapes"]:
            yards = "".join(f"; {k[:-3]} {s[k]:.4f} ms" for k in ("amax_ms", "flat_amax_ms",
                                                                  "copy_ms") if k in s)
            print(f"    ({s['M']}, {s['K']}) x {s['sites']}: {s['ms']:.4f} ms per launch, "
                  f"{s['GB_per_s']:.0f} GB/s (clean L2 {s['clean_ms']:.4f} ms, "
                  f"{s['clean_GB_per_s']:.0f} GB/s), bound {s['bound_ms']:.4f} ms{yards}")
    tiny = site_map(64, 64, 8, 8, torch.float32, device)
    host = {f"zebra_{r.kernel}_kernel": host_us(kernel_call(r, tiny)[0])
            for name, r in ROWS.items() if name.startswith("CNN")}
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
