"""Time variants of the 16-bit (tensor-core) GEMM body
(``csrc/zebra_gemm.cu``) at the gemma3-4b prefill's shape, on one card::

    PYTHONPATH=src python -m repro_torch.kernels.gemm_variants [--dtype float16] [--out FILE]

A variant is the shipped source with tile constants replaced, or with one
named piece of the body cut out (an ablation: its outputs are wrong, and its
time says where the shipped kernel's time goes). Each variant is compiled by
its own ``nvcc``, all at once, into ``build/repro_torch/variants/<name>/``,
and both kernels of each are timed with CUDA events, the L2 cache flushed
before each launch. The input is one ffn_hidden-shaped GEMM: a (4096, 10240)
map whose 8 x 128 block maxima are spread so that T_obj at their 0.669
quantile kills 66.9 % of the blocks (the served maps' zero fraction), and w
(10240, 2560), both from seed 0, in ``--dtype`` (bfloat16, the served type,
or float16), beside ``torch.matmul`` of the gated map in that dtype. Prints
one line per variant and writes them as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from . import build, mask_pack, zebra_spmm
from .schedule import slot_map

M, K, N, BS, BC, ZERO_FRACTION = 4096, 10240, 2560, 8, 128, 0.669

_CTAS = "std::is_same<T, float>::value ? 1 : 2;"
_FULL_STAGE = "  if (len == kStageK) {"
_MMA = "        if ((kLive >> r) & 1u) mma_tc<T>(acc[4 * G + r][j], a[ks][j], b[r]);"
_W_COPY = "      cp_async16(st + w_off(k, c), in ? src : w, in ? 16 : 0);"
_X_COPY = ("    cp_async16(st + x_off(b, r, c), in ? blk + r * stride + k0 + c * 8 : w,\n"
           "               in ? 16 : 0);")
# name: (constants to replace, [(source text, replacement)], outputs checked)
VARIANTS = {
    "shipped": ({}, [], True),
    "one CTA per SM, 4 stages": ({"kStages": 4}, [(_CTAS, _CTAS.replace("2;", "1;"))], True),
    "A of a whole stage at once (kParts 1)": ({"kParts": 1}, [], True),
    "A of a quarter stage at once (kParts 4)": ({"kParts": 4}, [], True),
    "256 columns, 16 warps, one CTA per SM": (
        {"kTileNTc": 256}, [(_CTAS, _CTAS.replace("2;", "1;"))], True),
    "a test per row and k16 step (no dispatch)": (
        {}, [(_FULL_STAGE, "  if (false) {")], True),
    "ablation: no MMAs": ({}, [(_MMA, "        ;")], False),
    "ablation: no global loads": (
        {}, [(_W_COPY, "      (void)in;"), (_X_COPY, "    (void)in;")], False),
}


def variant_source(consts: dict, patches: list) -> str:
    src = (build.CSRC / "zebra_gemm.cu").read_text()
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                         src)
        if n != 1:
            raise ValueError(f"constant {name} not found once in zebra_gemm.cu")
    for old, new in patches:
        if src.count(old) != 1:
            raise ValueError(f"patch text not found once in zebra_gemm.cu: {old!r}")
        src = src.replace(old, new)
    return src


def compile_all(root: Path, dtype: torch.dtype) -> dict[str, tuple[Path, str]]:
    """{variant: (library, ptxas lines of its kernels in ``dtype``)}, one
    nvcc each, all running at once."""
    mangled = {torch.bfloat16: "bfloat16", torch.float16: "__half"}[dtype]
    procs = {}
    for name, (consts, patches, _) in VARIANTS.items():
        d = root / re.sub(r"\W+", "_", name)
        d.mkdir(parents=True, exist_ok=True)
        (d / "zebra_gemm.cu").write_text(variant_source(consts, patches))
        log = open(d / "nvcc.log", "w")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "zebra_gemm.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log)
    out = {}
    for name, (d, proc, log) in procs.items():
        rc = proc.wait()
        log.close()
        text = (d / "nvcc.log").read_text()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{text}")
        lines = text.splitlines()
        info = [lines[i + j].strip() for i, l in enumerate(lines)
                if "Compiling entry" in l and mangled in l for j in (1, 2)
                if i + j < len(lines)]
        out[name] = (d / "lib.so", " | ".join(x for x in info if "spill" in x or "Used" in x))
    return out


def operands(device, dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(M, K, generator=g)
    x = (x.reshape(M // BS, BS, K // BC, BC)
         * torch.rand(M // BS, 1, K // BC, 1, generator=g) * 3.0).reshape(M, K)
    x = x.to(dtype).to(device)
    blockmax = x.float().reshape(M // BS, BS, K // BC, BC).abs().amax(dim=(1, 3))
    t_obj = float(torch.quantile(blockmax.flatten().cpu(), ZERO_FRACTION))
    w = (torch.randn(K, N, generator=g) / K ** 0.5).to(dtype).to(device)
    bitmap = mask_pack.bitmap_plain(x, t_obj, BS, BC)
    keep, slot = slot_map(bitmap)
    payload = mask_pack.pack_plain(x, bitmap, slot, keep.sum(dtype=torch.int32), BS, BC)
    return x, w, bitmap, slot, payload, int(keep.sum())


def time_ms(fn, flush, iters: int = 10) -> float:
    """Mean device time of one call (CUDA events, L2 flushed before each)."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float16"])
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gemm_variants: needs a CUDA card")
    device = torch.device("cuda")
    dtype = getattr(torch, args.dtype)
    code = zebra_spmm.GEMM_DTYPES[dtype]
    libs = compile_all(build.BUILD_ROOT / "variants", dtype)
    x, w, bitmap, slot, payload, n_live = operands(device, dtype)
    nm, nk = bitmap.shape
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=device)
    gated = zebra_spmm.gate_blocks(x, bitmap, BS, BC)
    want = gated.float() @ w.float()
    flops = 2 * n_live * BS * BC * N
    lib_ms = time_ms(lambda: torch.matmul(gated, w), flush)
    print(f"{torch.cuda.get_device_name(0)}; {args.dtype}; zero fraction "
          f"{1 - n_live / bitmap.numel():.4f}; torch.matmul of the gated map {lib_ms:.4f} ms")
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for name, (path, ptxas) in libs.items():
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in build.SOURCES["zebra_gemm.cu"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        y6, y7 = torch.empty(M, N, device=device), torch.empty(M, N, device=device)

        def k6():
            return lib.zebra_spmm_launch(x.data_ptr(), w.data_ptr(), bitmap.data_ptr(),
                                         y6.data_ptr(), M, K, N, BS, BC, code, stream)

        def k7():
            return lib.zebra_spmm_cs_launch(payload.data_ptr(), slot.data_ptr(), w.data_ptr(),
                                            bitmap.data_ptr(), y7.data_ptr(), nm, nk, N, BS,
                                            BC, code, stream)
        if k6() or k7():
            raise RuntimeError(f"variant {name!r} did not launch")
        torch.cuda.synchronize()
        row = {"variant": name, "ptxas": ptxas, "zebra_spmm_ms": time_ms(k6, flush),
               "zebra_spmm_cs_ms": time_ms(k7, flush)}
        row["tflops_live"] = flops / (row["zebra_spmm_cs_ms"] * 1e-3) / 1e12
        if VARIANTS[name][2]:
            row["bitwise_6_eq_7"] = bool(torch.equal(y6.view(torch.int32), y7.view(torch.int32)))
            row["max_abs_err"] = float((y7 - want).abs().max())
            if not (row["bitwise_6_eq_7"] and torch.allclose(y7, want, rtol=1e-4, atol=1e-4)):
                raise RuntimeError(f"variant {name!r} is wrong: {row}")
        rows.append(row)
        print(f"{name}: zebra_spmm {row['zebra_spmm_ms']:.4f} ms, zebra_spmm_cs "
              f"{row['zebra_spmm_cs_ms']:.4f} ms, {row['tflops_live']:.1f} TFLOP/s live; "
              f"{ptxas}")
    if args.out:
        Path(args.out).write_text(json.dumps({"device": torch.cuda.get_device_name(0),
                                              "dtype": args.dtype,
                                              "torch_matmul_ms": lib_ms, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
