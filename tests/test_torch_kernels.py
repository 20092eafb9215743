"""The port's stream kernels (plain versions on the CPU) against the
reference package: ``zebra_mask_pack``, ``zebra_unpack``, ``slot_map`` and
the ``ref`` oracles must agree bit for bit — payload, bitmap, n_live, the
unpacked map and ``stream_bytes``. Inputs are made once with numpy (or
``jax.random``, as the kernel bench draws them) and handed to both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import stream_bytes as jax_stream_bytes
from repro.kernels import ref as jref
from repro.kernels.mask_pack import zebra_mask_pack as jax_mask_pack
from repro.kernels.pack import zebra_unpack as jax_unpack
from repro.kernels.schedule import consumer_schedule as jax_schedule
from repro.kernels.schedule import slot_map as jax_slot_map
from repro_torch.core.engine import stream_bytes
from repro_torch.kernels import ref as tref
from repro_torch.kernels.mask_pack import (bitmap_plain, mask_pack_with_slots,
                                           pack_plain, zebra_mask_pack)
from repro_torch.kernels.pack import unpack_with_slots, zebra_unpack
from repro_torch.kernels.schedule import consumer_schedule, slot_map

from _torch_parity import bits

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def bench_map() -> np.ndarray:
    """The kernel-bench input (benchmarks/kernel_bench.py): M, K = 256, 1024
    with (8, 128) blocks, ~40% of blocks scaled up. BENCH_kernels.json was
    recorded under the non-partitionable threefry stream (the older JAX
    default), so the draw pins it."""
    M, K, bs, bc = 256, 1024, 8, 128
    with jax.threefry_partitionable(False):
        x = jax.random.normal(jax.random.PRNGKey(0), (M, K), jnp.float32)
        live = jax.random.uniform(jax.random.PRNGKey(1), (M // bs, K // bc)) < 0.4
    x = x * jnp.repeat(jnp.repeat(live.astype(jnp.float32), bs, 0), bc, 1) * 2 + x * 0.01
    return np.array(x)


def nchw_map(b: int, seed: int) -> np.ndarray:
    """A post-ReLU (B, C, H, W) map flattened to (B*C*H, W), b x b blocks."""
    rng = np.random.default_rng(seed)
    B, C, H, W = 2, 3, 4 * b, 4 * b
    scale = rng.uniform(0.0, 2.0, size=(B, C, H // b, 1, W // b, 1))
    x = np.maximum(rng.normal(size=(B, C, H // b, b, W // b, b)), 0.0) * scale
    return x.reshape(B * C * H, W).astype(np.float32)


def nan_inf_map() -> np.ndarray:
    x = nchw_map(4, 7)
    bs = bc = 4
    blockmax = np.abs(x.reshape(x.shape[0] // bs, bs, x.shape[1] // bc, bc)).max((1, 3))
    live = np.argwhere(blockmax >= 0.5)[0]
    dead = np.argwhere(blockmax < 0.5)[0]
    x[live[0] * bs + 1, live[1] * bc + 2] = np.nan     # kills a live block
    x[dead[0] * bs, dead[1] * bc + 3] = np.inf         # revives a dead block
    return x


def block_map(M: int, K: int, bs: int, bc: int, seed: int, relu: bool) -> np.ndarray:
    """An (M, K) map of (bs, bc) blocks, each scaled by U(0, 3) so that some
    fall under T_obj; post-ReLU when ``relu``."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.0, 3.0, size=(M // bs, 1, K // bc, 1))
    x = rng.normal(size=(M // bs, bs, K // bc, bc)) * scale
    if relu:
        x = np.maximum(x, 0.0)
    return x.reshape(M, K).astype(np.float32)


CASES = {
    "bench-f32": lambda: (bench_map(), "f32", 8, 128, 0.5),
    "bench-bf16": lambda: (bench_map(), "bf16", 8, 128, 0.5),
    "all-dead": lambda: (bench_map() * 0.01, "f32", 8, 128, 0.5),
    "all-live": lambda: (bench_map() + 10.0, "f32", 8, 128, 0.5),
    "nchw-b2": lambda: (nchw_map(2, 2), "f32", 2, 2, 1.0),
    "nchw-b4": lambda: (nchw_map(4, 4), "f32", 4, 4, 1.0),
    "nchw-b8": lambda: (nchw_map(8, 8), "f32", 8, 8, 1.0),
    "nchw-b8-bf16": lambda: (nchw_map(8, 9), "bf16", 8, 8, 1.0),
    "nan-live-inf-dead": lambda: (nan_inf_map(), "f32", 4, 4, 0.5),
    # the CUDA kernels' geometry branches (tests/test_torch_gpu_kernels.py
    # holds each kernel to these plain versions): two 8-row register passes
    # per lane, 32 vectors per block row, 96-byte map rows that split a
    # block's rows among lanes, and one 32-byte block per map row
    "bs16-bf16": lambda: (block_map(256, 1024, 16, 128, 16, False), "bf16", 16, 128, 4.0),
    "8x256-bf16": lambda: (block_map(128, 2048, 8, 256, 17, False), "bf16", 8, 256, 4.0),
    "k24-f32": lambda: (block_map(512, 24, 8, 8, 18, True), "f32", 8, 8, 3.0),
    "k8-f32": lambda: (block_map(512, 8, 8, 8, 19, True), "f32", 8, 8, 3.0),
}


def both(case):
    x_np, dt, bs, bc, t_obj = CASES[case]()
    tdt, jdt = DTYPES[dt]
    return (torch.from_numpy(x_np).to(tdt), jnp.asarray(x_np).astype(jdt),
            bs, bc, t_obj)


@pytest.mark.parametrize("case", ["bench-f32", "nchw-b2", "nchw-b4", "nchw-b8",
                                  "nan-live-inf-dead"])
def test_float16_maps_bitwise_vs_reference(case):
    """A float16 map through the comparator, the masking pass and the
    producer + expander, against the JAX package on the same numpy input:
    bitmap, masked map (NaN as NaN), payload, n_live and the expanded map
    bit for bit."""
    from repro.kernels.zebra_mask import zebra_mask as jax_mask
    from repro_torch.kernels.mask_pack import zebra_bitmap
    from repro_torch.kernels.zebra_mask import zebra_mask
    x_np, _, bs, bc, t_obj = CASES[case]()
    xt, xj = torch.from_numpy(x_np).half(), jnp.asarray(x_np, jnp.float16)
    bitmap = zebra_bitmap(xt, t_obj=t_obj, bs=bs, bc=bc)
    payload, bm, n_live = zebra_mask_pack(xt, t_obj=t_obj, bs=bs, bc=bc)
    jp, jb, jn = jax_mask_pack(xj, t_obj=t_obj, bs=bs, bc=bc, interpret=True)
    np.testing.assert_array_equal(bits(bitmap), bits(jb))
    np.testing.assert_array_equal(bits(bm), bits(jb))
    assert payload.dtype == torch.float16 and int(n_live) == int(jn)
    np.testing.assert_array_equal(bits(payload), bits(jp))
    np.testing.assert_array_equal(bits(zebra_unpack(payload, bitmap, bs=bs, bc=bc)),
                                  bits(jax_unpack(jp, jb, bs=bs, bc=bc, interpret=True)))
    y, bm2 = zebra_mask(xt, t_obj=t_obj, bs=bs, bc=bc)
    jy, jb2 = jax_mask(xj, t_obj=t_obj, bs=bs, bc=bc, interpret=True)
    np.testing.assert_array_equal(bits(bm2), bits(jb2))
    nan = np.isnan(np.asarray(jy, np.float32))
    assert np.array_equal(torch.isnan(y).numpy(), nan)
    np.testing.assert_array_equal(bits(y)[~nan], bits(jy)[~nan])
    assert 0 < int(n_live) < bitmap.numel()


@pytest.mark.parametrize("case", list(CASES))
def test_mask_pack_and_unpack_bitwise_vs_reference(case):
    xt, xj, bs, bc, t_obj = both(case)
    payload, bitmap, n_live = zebra_mask_pack(xt, t_obj=t_obj, bs=bs, bc=bc)
    jp, jb, jn = jax_mask_pack(xj, t_obj=t_obj, bs=bs, bc=bc, interpret=True)
    np.testing.assert_array_equal(bits(bitmap), bits(jb))
    assert int(n_live) == int(jn)
    np.testing.assert_array_equal(bits(payload), bits(jp))
    # and both equal the oracles
    rp, rb, rn = jref.zebra_mask_pack_ref(xj, t_obj, bs, bc)
    tp, tb, tn = tref.zebra_mask_pack_ref(xt, t_obj, bs, bc)
    np.testing.assert_array_equal(bits(payload), bits(rp))
    np.testing.assert_array_equal(bits(tp), bits(rp))
    np.testing.assert_array_equal(bits(tb), bits(rb))
    assert int(tn) == int(rn) == int(n_live)

    y = zebra_unpack(payload, bitmap, bs=bs, bc=bc)
    jy = jax_unpack(jp, jb, bs=bs, bc=bc, interpret=True)
    np.testing.assert_array_equal(bits(y), bits(jy))
    # the engine's form: the expander reuses the producer's slot map
    _, _, _, keep, slot = mask_pack_with_slots(xt, t_obj=t_obj, bs=bs, bc=bc)
    np.testing.assert_array_equal(
        bits(unpack_with_slots(payload, bitmap, keep, slot, bs=bs, bc=bc)), bits(y))
    np.testing.assert_array_equal(bits(tref.zebra_unpack_ref(payload, bitmap, bs, bc)),
                                  bits(jref.zebra_unpack_ref(jp, jb, bs, bc)))
    assert int(stream_bytes(n_live, bs, bc, xt.dtype, bitmap.numel())) == int(
        jax_stream_bytes(jn, bs, bc, xj.dtype, jb.size))


def test_bench_point_stream_bytes():
    """The kernel-bench point's recorded stream length (BENCH_kernels.json)."""
    xt, xj, bs, bc, t_obj = both("bench-f32")
    _, bitmap, n_live = zebra_mask_pack(xt, t_obj=t_obj, bs=bs, bc=bc)
    assert int(stream_bytes(n_live, bs, bc, xt.dtype, bitmap.numel())) == 380960


@pytest.mark.parametrize("case", ["all-dead", "nan-live-inf-dead"])
def test_edge_cases_semantics(case):
    xt, _, bs, bc, t_obj = both(case)
    payload, bitmap, n_live = zebra_mask_pack(xt, t_obj=t_obj, bs=bs, bc=bc)
    y = zebra_unpack(payload, bitmap, bs=bs, bc=bc)
    if case == "all-dead":
        assert int(n_live) == 0 and not bitmap.any()
        assert not payload.any() and not y.any()
        return
    # NaN block dead (max propagates NaN), Inf block live; dead blocks are
    # exact +0 (sign bit clear), never NaN
    assert not torch.isnan(y).any() and torch.isinf(y).sum() == 1
    dead = (bitmap == 0).repeat_interleave(bs, 0).repeat_interleave(bc, 1)
    assert (bits(y)[dead.numpy()] == 0).all()


@pytest.mark.parametrize("case", ["bench-f32", "all-dead", "nchw-b2"])
def test_slot_map_and_schedule_vs_reference(case):
    xt, xj, bs, bc, t_obj = both(case)
    bitmap = bitmap_plain(xt, t_obj, bs, bc)
    jb = jref.zebra_mask_ref(xj, t_obj, bs, bc)[1]
    keep, slot = slot_map(bitmap)
    jkeep, jslot = jax_slot_map(jb)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    sched, jsched = consumer_schedule(bitmap), jax_schedule(jb)
    for name in sched._fields:
        np.testing.assert_array_equal(getattr(sched, name).numpy(),
                                      np.asarray(getattr(jsched, name)), err_msg=name)


def test_pack_plain_ignores_dead_block_values():
    """Dead blocks of the RAW map (not zeroed first) never reach the payload."""
    xt, xj, bs, bc, t_obj = both("nchw-b4")
    bitmap = bitmap_plain(xt, t_obj, bs, bc)
    keep, slot = slot_map(bitmap)
    payload = pack_plain(xt, bitmap, slot, keep.sum(dtype=torch.int32), bs, bc)
    ref_payload, _ = jref.zebra_pack_ref(jref.zebra_mask_ref(xj, t_obj, bs, bc)[0],
                                         jnp.asarray(bitmap.numpy()), bs, bc)
    np.testing.assert_array_equal(bits(payload), bits(ref_payload))


def test_stream_timing_refuses_to_time_without_a_card():
    """The comparator/masking-kernel timing script imports on the CPU and
    refuses to run there: it reports device times only."""
    from repro_torch.kernels import stream_timing
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would time it")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        stream_timing.main([])
    assert sum(n for _, shapes, *_ in stream_timing.ROWS.values()
               for *_, n in shapes) == 17 + 17 + 34 + 68 + 17 + 17 + 34
