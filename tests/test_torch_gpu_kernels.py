"""Each CUDA kernel of the port against its plain PyTorch version, on the
card, bit for bit. Marked ``gpu``: each test decides inside itself whether
a card is present and skips here with a reason. On a machine with an H100:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_kernels.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mask_pack, pack, zebra_mask
from repro_torch.kernels.schedule import slot_map

pytestmark = pytest.mark.gpu

# (M, K, bs, bc, dtype, t_obj, kind)
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
    x = (x.reshape(M // bs, bs, K // bc, bc) * scale).reshape(M, K)
    if kind != "signed":
        x = x.clamp_min(0.0)
    if kind == "nan-inf":
        x[1, 2] = float("nan")
        x[9, 17] = float("inf")
        x[17, 40] = float("-inf")
    return x.to(dtype).to(device), bs, bc, t_obj


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
    # the payload comes from torch.empty: the kernel must write every slot
    got = mask_pack.pack_cuda(x, bitmap, slot, n_live, bs, bc)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(bits(got),
                                  bits(mask_pack.pack_plain(x, bitmap, slot, n_live, bs, bc)))


@pytest.mark.parametrize("case", list(CASES))
def test_unpack_kernel_matches_plain(case, cuda):
    x, bs, bc, t_obj = make_map(case, cuda)
    bitmap = mask_pack.bitmap_plain(x, t_obj, bs, bc)
    keep, slot = slot_map(bitmap)
    payload = mask_pack.pack_plain(x, bitmap, slot, keep.sum(dtype=torch.int32), bs, bc)
    nm, nk = bitmap.shape
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
    np.testing.assert_array_equal(bits(y), bits(want_y))


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
