"""The port's one-pass masking kernel (``kernels.zebra_mask``, its plain
version on the CPU) against the reference's Pallas ``zebra_mask`` in
interpret mode, on the same numpy inputs.

Tolerance: bit for bit through an integer view, so ``-0.0`` in dead blocks
of signed maps counts, and so does a NaN where the reference has one. Only
the payload bits of a NaN in bfloat16 are left out: PyTorch's vectorised
CPU rounding to bfloat16 writes every NaN as 0xFFFF where XLA writes
0x7FC0, and the card writes 0x7FFF; a NaN must still be a NaN in both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.zebra_mask import zebra_mask as jax_mask
from repro_torch.kernels import launch_counters
from repro_torch.kernels.zebra_mask import mask_plain, zebra_mask

from _torch_parity import bits

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
BLOCKS = {"8x8": (64, 64, 8, 8), "4x4": (32, 16, 4, 4), "2x2": (16, 8, 2, 2),
          "8x128": (32, 256, 8, 128)}
# every map kind at every block shape, in both dtypes; all-dead and
# all-live (a threshold above or below every block) at 8x8
CASES = [(d, b, k) for d in DTYPES for b in BLOCKS
         for k in ("signed", "relu", "nan-inf")] + \
        [(d, "8x8", k) for d in DTYPES for k in ("all-dead", "all-live")]


def make_map(M, K, bs, bc, kind, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)) * np.repeat(np.repeat(
        rng.uniform(0.0, 2.0, size=(M // bs, K // bc)), bs, 0), bc, 1)
    if kind not in ("signed", "nan-inf"):
        x = np.maximum(x, 0.0)
    if kind == "nan-inf":
        x[1, 2] = np.nan                 # its block is dead: NaN * 0
        x[M - 1, K - 1] = np.inf         # its block is live: Inf * 1
        x[M // 2, 1] = -np.inf
    # about half the blocks dead: the median block max, to two decimals
    blockmax = np.abs(x.reshape(M // bs, bs, K // bc, bc)).max(axis=(1, 3))
    t_obj = {"all-dead": 1e9, "all-live": 0.0}.get(
        kind, round(float(np.median(blockmax[np.isfinite(blockmax)])), 2))
    return x.astype(np.float32), t_obj


def _nan_canonical(b: np.ndarray, a) -> np.ndarray:
    """The bit patterns with every NaN set to one value (see the module
    docstring)."""
    nan = np.isnan(np.asarray(a, np.float32))
    return np.where(nan, -1, b)


@pytest.mark.parametrize("dtype,block,kind", CASES)
def test_mask_matches_reference(dtype, block, kind):
    M, K, bs, bc = BLOCKS[block]
    tdt, jdt = DTYPES[dtype]
    x, t_obj = make_map(M, K, bs, bc, kind, seed=len(block) + len(kind))
    y, bitmap = zebra_mask(torch.from_numpy(x).to(tdt), t_obj=t_obj, bs=bs, bc=bc)
    jy, jbitmap = jax_mask(jnp.asarray(x, jdt), t_obj=t_obj, bs=bs, bc=bc,
                           interpret=True)
    np.testing.assert_array_equal(bitmap.numpy(), np.asarray(jbitmap))
    assert bitmap.dtype == torch.int8 and y.dtype == tdt
    np.testing.assert_array_equal(_nan_canonical(bits(y), y.float()),
                                  _nan_canonical(bits(jy), jy))
    if kind == "all-dead":
        assert not bitmap.any()
    if kind == "all-live":
        assert bitmap.all() and torch.equal(y, torch.from_numpy(x).to(tdt))
    if kind in ("signed", "nan-inf"):  # dead negative values come out as -0.0
        assert (bits(y) == bits(torch.tensor(-0.0, dtype=tdt))).any()


def test_plain_runs_on_cpu_without_a_launch():
    x, t_obj = make_map(64, 64, 8, 8, "relu")
    before = zebra_mask.launches
    y, bitmap = zebra_mask(torch.from_numpy(x), t_obj=t_obj, bs=8, bc=8)
    assert zebra_mask.launches == before
    want_y, want_bitmap = mask_plain(torch.from_numpy(x), t_obj, 8, 8)
    assert torch.equal(y, want_y) and torch.equal(bitmap, want_bitmap)
    assert launch_counters()["zebra_mask_kernel"] is zebra_mask


def test_mask_rejects_maps_off_the_block_grid():
    with pytest.raises(ValueError, match="must divide"):
        zebra_mask(torch.ones(12, 16), t_obj=0.5, bs=8, bc=8)
