"""Each CUDA kernel of the port against its plain PyTorch version, on the
card: bit for bit, except the GEMMs, which are held to a stated tolerance
against their plain version and bit for bit against each other. Marked
``gpu``: each test decides inside itself whether a card is present and
skips here with a reason. On a machine with an H100:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_kernels.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mask_pack, pack, zebra_mask
from repro_torch.kernels.schedule import slot_map

pytestmark = pytest.mark.gpu

# (M, K, bs, bc, dtype, t_obj, kind). The comparator and the masking kernel
# load 16-byte vectors where bc*item, K*item and the data pointers allow,
# else 8, 4 or 2 bytes: "k6-b2", "k12-bf16" and "k36-bf16-8x12" have rows of
# 24 and 72 bytes, "offset-*" and "row-slice" start off 16 bytes (kinds
# ending in "+offN" start N elements into their storage, "+row1" one row
# into a map one row taller). "bf16-8x24" and "k36-bf16-8x12" give a block
# 3 vectors wide (a group of 4 lanes, one idle), "f32-8x256" 64 (two passes
# per lane), "bs16" more rows than a lane holds, "bf16-3x5" 2-byte vectors
# (and a pack zero tail that starts mid-line); "grid-stride" has more blocks
# than the grid has lanes for, and its "-few-live" and "-most-live" twins
# leave about 1 % of the blocks live or dead ("few" and "most" kinds). Kinds
# ending in "+payoffN" hand the expander a payload that starts N elements
# into its storage (off 16 bytes); "ffn-hidden" is gemma3-4b's FFN map
_F16 = torch.float16
CASES = {
    "site-k64": (8192, 64, 8, 8, torch.float32, 1.5, "relu"),
    "site-k8": (8192, 8, 8, 8, torch.float32, 1.5, "relu"),
    "bf16": (4096, 64, 8, 8, torch.bfloat16, 1.5, "relu"),
    "tokens-8x128": (256, 1024, 8, 128, torch.float32, 0.5, "signed"),
    "tokens-bf16": (256, 1024, 8, 128, torch.bfloat16, 0.5, "signed"),
    "nchw-b2": (2048, 32, 2, 2, torch.float32, 1.0, "relu"),
    "nchw-b4": (2048, 32, 4, 4, torch.float32, 1.0, "relu"),
    "all-dead": (1024, 64, 8, 8, torch.float32, 100.0, "relu"),
    "all-live": (1024, 64, 8, 8, torch.float32, 0.0, "relu"),
    "nan-inf": (1024, 64, 8, 8, torch.float32, 1.5, "nan-inf"),
    "f16": (4096, 64, 8, 8, _F16, 1.5, "relu"),
    "f16-tokens": (256, 1024, 8, 128, _F16, 0.5, "signed"),
    "f16-nan-inf": (1024, 64, 8, 8, _F16, 1.5, "nan-inf"),
    "k24-f32": (1024, 24, 8, 8, torch.float32, 1.5, "relu"),
    "k40-bf16": (1024, 40, 8, 8, torch.bfloat16, 1.5, "relu"),
    "k6-b2": (2048, 6, 2, 2, torch.float32, 1.0, "relu"),
    "k12-bf16": (1024, 12, 8, 4, torch.bfloat16, 1.0, "signed"),
    "k36-bf16-8x12": (1024, 36, 8, 12, torch.bfloat16, 1.0, "signed"),
    "offset-f32": (1024, 64, 8, 8, torch.float32, 1.5, "relu+off1"),
    "offset-bf16": (1024, 64, 8, 8, torch.bfloat16, 1.5, "signed+off4"),
    "row-slice": (1024, 36, 4, 12, torch.bfloat16, 1.0, "signed+row1"),
    "bf16-8x24": (512, 480, 8, 24, torch.bfloat16, 0.5, "signed"),
    "bf16-8x256": (256, 2048, 8, 256, torch.bfloat16, 0.5, "signed"),
    "f32-8x256": (256, 1024, 8, 256, torch.float32, 0.5, "signed"),
    "bs16": (1024, 256, 16, 128, torch.bfloat16, 0.5, "signed"),
    "bf16-3x5": (96, 25, 3, 5, torch.bfloat16, 1.0, "signed"),
    "grid-stride": (262144, 64, 8, 8, torch.float32, 1.5, "relu"),
    "kv-cache": (4096, 1280, 8, 128, torch.bfloat16, 1.05, "signed"),
    "ffn-hidden": (4096, 10240, 8, 128, torch.bfloat16, 1.05, "signed"),
    "grid-stride-few-live": (262144, 64, 8, 8, torch.float32, 1.5, "few"),
    "grid-stride-most-live": (262144, 64, 8, 8, torch.float32, 1.5, "most"),
    "payload-off-f32": (1024, 64, 8, 8, torch.float32, 1.5, "relu+payoff1"),
    "payload-off-bf16": (256, 1024, 8, 128, torch.bfloat16, 0.5, "signed+payoff4"),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def make_map(case, device):
    M, K, bs, bc, dtype, t_obj, kind = CASES[case]
    g = torch.Generator().manual_seed(sum(map(ord, case)))
    x = torch.randn(M, K, generator=g)
    scale = torch.rand(M // bs, 1, K // bc, 1, generator=g) * 3.0
    kind, _, place = kind.partition("+")
    if kind in ("few", "most"):         # ~1 % of the blocks live, or dead
        rare = torch.rand(scale.shape, generator=g) < 0.01
        scale = torch.where(rare == (kind == "few"), 3.0, 0.01)
    x = (x.reshape(M // bs, bs, K // bc, bc) * scale).reshape(M, K)
    if kind != "signed":
        x = x.clamp_min(0.0)
    if kind == "nan-inf":
        x[1, 2] = float("nan")
        x[9, 17] = float("inf")
        x[17, 40] = float("-inf")
    x = x.to(dtype).to(device)
    if place.startswith("off"):         # a contiguous view N elements into its storage
        n = int(place[3:])
        x = torch.cat([x.new_zeros(n), x.reshape(-1)])[n:].view(M, K)
    elif place == "row1":               # rows 1.. of a map one row taller
        x = torch.cat([x.new_zeros(1, K), x])[1:]
    assert x.is_contiguous() and (not place.startswith(("off", "row")) or x.data_ptr() % 16)
    return x, bs, bc, t_obj


def place_payload(case, payload):
    """The payload the expander gets: for a "+payoffN" kind a contiguous
    view N elements into its storage, else the payload itself."""
    place = CASES[case][-1].partition("+")[2]
    if not place.startswith("payoff"):
        return payload
    n = int(place[6:])
    payload = torch.cat([payload.new_zeros(n), payload.reshape(-1)])[n:].view(payload.shape)
    assert payload.is_contiguous() and payload.data_ptr() % 16
    return payload


def dirty_allocator(t):
    """Leaves a freed block of t's size full of 0xff bytes in the caching
    allocator, so the next torch.empty of that size reads garbage unless
    the kernel writes every byte."""
    junk = torch.empty_like(t)
    junk.view(-1).view(torch.uint8).fill_(0xff)
    del junk


def assert_bits(got, want):
    """Bit for bit; a 16-bit NaN only as NaN (the kernel and PyTorch's
    float16/bfloat16 multiply may round NaN to different payloads)."""
    if got.is_floating_point() and got.element_size() == 2:
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        got, want = got[~nan], want[~nan]
    np.testing.assert_array_equal(bits(got), bits(want))


def bits(t):
    t = t.cpu()
    if t.is_floating_point():
        t = t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
    return t.numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_bitmap_kernel_matches_plain(case, cuda):
    x, bs, bc, t_obj = make_map(case, cuda)
    got = mask_pack.bitmap_cuda(x, t_obj, bs, bc)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(bits(got), bits(mask_pack.bitmap_plain(x, t_obj, bs, bc)))


@pytest.mark.parametrize("case", list(CASES))
def test_pack_kernel_matches_plain(case, cuda):
    x, bs, bc, t_obj = make_map(case, cuda)
    bitmap = mask_pack.bitmap_plain(x, t_obj, bs, bc)
    keep, slot = slot_map(bitmap)
    n_live = keep.sum(dtype=torch.int32)
    want = mask_pack.pack_plain(x, bitmap, slot, n_live, bs, bc)
    # the payload comes from torch.empty: the kernel must write every slot
    dirty_allocator(want)
    got = mask_pack.pack_cuda(x, bitmap, slot, n_live, bs, bc)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("case", list(CASES))
def test_unpack_kernel_matches_plain(case, cuda):
    x, bs, bc, t_obj = make_map(case, cuda)
    bitmap = mask_pack.bitmap_plain(x, t_obj, bs, bc)
    keep, slot = slot_map(bitmap)
    payload = mask_pack.pack_plain(x, bitmap, slot, keep.sum(dtype=torch.int32), bs, bc)
    payload = place_payload(case, payload)
    nm, nk = bitmap.shape
    dirty_allocator(x)          # the map comes from torch.empty: every byte written
    got = pack.unpack_cuda(payload, bitmap, slot, bs, bc)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        bits(got), bits(pack.expand_payload(payload, keep, slot, nm, nk, bs, bc)))


@pytest.mark.parametrize("case", list(CASES))
def test_mask_kernel_matches_plain(case, cuda):
    x, bs, bc, t_obj = make_map(case, cuda)
    y, bitmap = zebra_mask.mask_cuda(x, t_obj, bs, bc)
    torch.cuda.synchronize()
    want_y, want_bitmap = zebra_mask.mask_plain(x, t_obj, bs, bc)
    np.testing.assert_array_equal(bits(bitmap), bits(want_bitmap))
    assert_bits(y, want_y)


def test_wrappers_launch_and_count(cuda):
    x, bs, bc, t_obj = make_map("site-k64", cuda)
    before = (mask_pack.zebra_bitmap.launches, mask_pack.pack_blocks.launches,
              pack.zebra_unpack.launches)
    payload, bitmap, n_live = mask_pack.zebra_mask_pack(x, t_obj=t_obj, bs=bs, bc=bc)
    y = pack.zebra_unpack(payload, bitmap, bs=bs, bc=bc)
    after = (mask_pack.zebra_bitmap.launches, mask_pack.pack_blocks.launches,
             pack.zebra_unpack.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    ref_y = x * (mask_pack.bitmap_plain(x, t_obj, bs, bc).to(x.dtype)
                 .repeat_interleave(bs, 0).repeat_interleave(bc, 1))
    assert torch.equal(y, ref_y)
    before = zebra_mask.zebra_mask.launches
    ym, bitmap_m = zebra_mask.zebra_mask(x, t_obj=t_obj, bs=bs, bc=bc)
    assert zebra_mask.zebra_mask.launches == before + 1
    assert torch.equal(ym, ref_y) and torch.equal(bitmap_m, bitmap)


def test_stream_wrappers_refuse_and_never_fall_back(cuda, monkeypatch):
    """A CUDA map the comparator or the masking kernel does not take raises
    from its wrapper, uncounted; no CUDA tensor reaches a plain version."""
    def no_plain(*a, **k):
        raise AssertionError("a CUDA tensor took the plain version")
    monkeypatch.setattr(mask_pack, "bitmap_plain", no_plain)
    monkeypatch.setattr(zebra_mask, "mask_plain", no_plain)
    before = (mask_pack.zebra_bitmap.launches, zebra_mask.zebra_mask.launches)
    x = torch.rand(64, 64, device=cuda)
    for bad, err in ((x.double(), TypeError), (x.t(), ValueError)):
        with pytest.raises(err):
            mask_pack.zebra_bitmap(bad, t_obj=0.5, bs=8, bc=8)
        with pytest.raises(err):
            zebra_mask.zebra_mask(bad, t_obj=0.5, bs=8, bc=8)
    assert (mask_pack.zebra_bitmap.launches, zebra_mask.zebra_mask.launches) == before
    zebra_mask.zebra_mask(x.half(), t_obj=0.5, bs=8, bc=8)
    mask_pack.zebra_bitmap(x.half(), t_obj=0.5, bs=8, bc=8)
    assert (mask_pack.zebra_bitmap.launches, zebra_mask.zebra_mask.launches) == \
        (before[0] + 1, before[1] + 1)


# ---------------------------------------------------------------------------
# The codec's pack entry and the payload GEMM with its dense twin
# ---------------------------------------------------------------------------

from repro_torch.kernels import spmm_cs, zebra_spmm  # noqa: E402

# GEMM tolerance: the kernel and the plain float32 matmul (TF32 off) sum the
# same products in different orders (bf16 products are exact in float32;
# the tensor cores sum each k16 step in their own order)
GEMM_TOL = dict(rtol=1e-4, atol=1e-4, equal_nan=True)
# (M, K, N, bs, bc, dtype, t_obj, kind); float32 runs the CUDA-core body,
# bfloat16 and float16 the tensor-core body (every bf16 case runs again in
# float16 under its "-f16" name). N = 300 and 130 take the 16-bit body's
# element-wise w staging (rows not 16-byte aligned), N % 8 == 0 its cp.async
# staging; 4x128 has block rows r >= bs zero-filled in the MMA; 8x24 ends
# each block with a half k16 step (bc % 16 == 8); bs 12 runs as two 6-row
# halves, bs 16 and 24 as 8-row sub-blocks (``zebra_spmm.split_rows``)
_F32, _BF16 = torch.float32, torch.bfloat16
GEMM_CASES = {
    "8x128-f32": (256, 1024, 384, 8, 128, _F32, 0.5, "signed"),
    "8x128-bf16": (256, 1024, 300, 8, 128, _BF16, 0.5, "signed"),
    "8x64-whole-width": (64, 64, 130, 8, 64, _F32, 0.5, "signed"),
    "all-dead": (128, 512, 128, 8, 128, _F32, 100.0, "signed"),
    "all-live": (128, 512, 128, 8, 128, _F32, 0.0, "signed"),
    "one-live-per-column": (128, 512, 128, 8, 128, _F32, 0.5, "one"),
    "nan-inf-map": (128, 512, 128, 8, 128, _F32, 0.5, "nan-inf"),
    "8x64-whole-width-bf16": (64, 64, 130, 8, 64, _BF16, 0.5, "signed"),
    "all-dead-bf16": (128, 512, 128, 8, 128, _BF16, 100.0, "signed"),
    "all-live-bf16": (128, 512, 128, 8, 128, _BF16, 0.0, "signed"),
    "one-live-per-column-bf16": (128, 512, 128, 8, 128, _BF16, 0.5, "one"),
    "nan-inf-map-bf16": (128, 512, 128, 8, 128, _BF16, 0.5, "nan-inf"),
    "4x128-bf16": (512, 1024, 256, 4, 128, _BF16, 0.5, "signed"),
    "8x24-bf16": (256, 480, 200, 8, 24, _BF16, 0.5, "signed"),
    "8x8-bf16": (256, 64, 136, 8, 8, _BF16, 0.5, "signed"),
    "16x128-bf16": (512, 1024, 256, 16, 128, _BF16, 0.5, "signed"),
    "16x128-f32": (256, 512, 128, 16, 128, _F32, 0.5, "signed"),
    "24x64-bf16": (384, 512, 136, 24, 64, _BF16, 0.5, "one"),
    "12x128-bf16": (384, 1024, 256, 12, 128, _BF16, 0.5, "signed"),
    "12x64-f32": (192, 512, 136, 12, 64, _F32, 0.5, "signed"),
    "24x128-f32": (384, 512, 128, 24, 128, _F32, 0.5, "signed"),
}
GEMM_CASES.update({k.replace("bf16", "f16"): (*v[:5], _F16, *v[6:])
                   for k, v in list(GEMM_CASES.items()) if v[5] == _BF16})


def gemm_operands(case, device):
    M, K, N, bs, bc, dtype, t_obj, kind = GEMM_CASES[case]
    g = torch.Generator().manual_seed(sum(map(ord, case)))
    x = torch.randn(M, K, generator=g)
    scale = torch.rand(M // bs, 1, K // bc, 1, generator=g) * 3.0
    if kind == "one":
        scale.fill_(0.01)
        rows = torch.randint(0, M // bs, (K // bc,), generator=g)
        scale[rows, 0, torch.arange(K // bc), 0] = 3.0
    x = (x.reshape(M // bs, bs, K // bc, bc) * scale).reshape(M, K)
    if kind == "nan-inf":
        x[1, 2] = float("nan")
        x[9, 200] = float("inf")
    w = torch.randn(K, N, generator=g) / K ** 0.5
    x, w = x.to(dtype).to(device), w.to(dtype).to(device)
    bitmap = mask_pack.bitmap_plain(x, t_obj, bs, bc)
    if kind == "nan-inf":
        bitmap[1, 1] = 1                # a live block holding Inf (given bitmap)
    keep, slot = slot_map(bitmap)
    payload = mask_pack.pack_plain(x, bitmap, slot, keep.sum(dtype=torch.int32), bs, bc)
    return x, w, bitmap, keep, slot, payload, bs, bc


@pytest.mark.parametrize("case", list(GEMM_CASES))
def test_gemm_kernels_match_plain_and_each_other(case, cuda):
    x, w, bitmap, keep, slot, payload, bs, bc = gemm_operands(case, cuda)
    y7 = spmm_cs.spmm_cs_cuda(payload, w, bitmap, slot, bs, bc)
    y6 = zebra_spmm.spmm_cuda(x, w, bitmap, bs, bc)
    torch.cuda.synchronize()
    assert y7.dtype == torch.float32 and torch.equal(y6.view(torch.int32), y7.view(torch.int32))
    want = spmm_cs.spmm_cs_plain(payload, w, bitmap, keep, slot, bs, bc)
    torch.testing.assert_close(y7, want, **GEMM_TOL)
    torch.testing.assert_close(y6, zebra_spmm.spmm_plain(x, w, bitmap, bs, bc), **GEMM_TOL)
    if case.startswith("all-dead"):
        assert not y7.any()


@pytest.mark.parametrize("case", ["8x128-f32", "8x128-bf16", "8x128-f16"])
def test_gemm_skips_dead_blocks_whatever_w_holds(case, cuda):
    """The skip rule, in both bodies: a dead block forms no product with
    its w panel, so Inf/NaN in the w rows of a dead block do not reach
    that block's rows in either kernel (the plain version, which
    multiplies the zeroed block, gives NaN there); rows whose block is
    live see them."""
    x, w, bitmap, keep, slot, payload, bs, bc = gemm_operands(case, cuda)
    col = int((bitmap == 0).any(0).nonzero()[0])        # a column with a dead block
    w_bad = w.clone()
    w_bad[col * bc + 3, :] = float("inf")
    w_bad[col * bc + 5, 7] = float("nan")
    y7 = spmm_cs.spmm_cs_cuda(payload, w_bad, bitmap, slot, bs, bc)
    y6 = zebra_spmm.spmm_cuda(x, w_bad, bitmap, bs, bc)
    torch.cuda.synchronize()
    assert torch.equal(y6.view(torch.int32), y7.view(torch.int32))
    dead_rows = (bitmap[:, col] == 0).repeat_interleave(bs)
    clean = spmm_cs.spmm_cs_cuda(payload, w, bitmap, slot, bs, bc)
    assert bool(torch.isfinite(y7[dead_rows]).all())
    torch.testing.assert_close(y7[dead_rows], clean[dead_rows], **GEMM_TOL)
    assert bool(torch.isnan(spmm_cs.spmm_cs_plain(payload, w_bad, bitmap, keep, slot, bs, bc)
                            [dead_rows]).any())
    assert not bool(torch.isfinite(y7[~dead_rows]).all())


@pytest.mark.parametrize("case", ["tokens-8x128", "tokens-bf16", "all-dead", "nan-inf"])
def test_zebra_pack_kernel_matches_plain(case, cuda):
    """``pack.zebra_pack`` under an external (nonzero-block) bitmap: the
    kernel's payload and n_live equal the plain version's bit for bit."""
    from repro_torch.compress import nonzero_bitmap
    x, bs, bc, t_obj = make_map(case, cuda)
    masked, _ = zebra_mask.mask_plain(x, t_obj, bs, bc)
    bitmap = nonzero_bitmap(masked, bs, bc)
    before = (pack.zebra_pack.launches, mask_pack.pack_blocks.launches)
    payload, n_live = pack.zebra_pack(masked, bitmap, bs=bs, bc=bc)
    torch.cuda.synchronize()
    assert (pack.zebra_pack.launches, mask_pack.pack_blocks.launches) == \
        (before[0] + 1, before[1])
    want, want_n = pack.zebra_pack(masked.cpu(), bitmap.cpu(), bs=bs, bc=bc)
    assert int(n_live) == int(want_n)
    np.testing.assert_array_equal(bits(payload), bits(want))


def test_gemm_wrappers_launch_count_and_never_fall_back(cuda, monkeypatch):
    x, w, bitmap, keep, slot, payload, bs, bc = gemm_operands("8x128-bf16", cuda)

    def no_plain(*a, **k):
        raise AssertionError("a CUDA tensor took the plain version")
    monkeypatch.setattr(spmm_cs, "spmm_cs_plain", no_plain)
    monkeypatch.setattr(zebra_spmm, "spmm_plain", no_plain)
    before = (zebra_spmm.zebra_spmm.launches, spmm_cs.zebra_spmm_cs.launches)
    y7 = spmm_cs.zebra_spmm_cs(payload, w, bitmap, bs=bs, bc=bc)
    y6 = zebra_spmm.zebra_spmm(x, w, bitmap, bs=bs, bc=bc)
    assert (zebra_spmm.zebra_spmm.launches, spmm_cs.zebra_spmm_cs.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(y6.view(torch.int32), y7.view(torch.int32))
    with pytest.raises(ValueError, match="bs >= 1"):       # refused, not run
        zebra_spmm.spmm_cuda(x, w, bitmap, 0, bc)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        zebra_spmm.spmm_cuda(x.double(), w.double(), bitmap, bs, bc)
    assert (zebra_spmm.zebra_spmm.launches, spmm_cs.zebra_spmm_cs.launches) == \
        (before[0] + 1, before[1] + 1)


def test_int8_compression_temporaries_are_a_few_chunks(cuda):
    """int8 gradient compression of a 1 GiB float32 gradient on the card:
    the memory it allocates above the gradient and its residual
    (``max_memory_allocated``) is a few chunks of ``compress.CHUNK``
    elements, not copies of the tensor."""
    from repro_torch.optim import compress
    n = (1 << 28) + 12345                     # 1 GiB of float32 and a ragged tail
    g = torch.randn(n, device=cuda)
    state = compress.init_state({"w": g}, "int8")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    dec, state = compress.compressed_gradients({"w": g}, state, "int8")
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(cuda) - base
    chunk_bytes = compress.CHUNK * 4
    print(f"int8 pass on {n} float32 elements: {extra} B above the gradient and its "
          f"residual ({extra / chunk_bytes:.4f} chunks)")
    assert dec["w"] is g and torch.isfinite(state.error["w"]).all()
    assert extra <= 6 * chunk_bytes, (extra, chunk_bytes)
    assert extra < n * 4 // 2, extra          # the unchunked pass: 4x the tensor and more
