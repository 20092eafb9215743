"""The port's codec (``compress/``) and ``kernels.pack.zebra_pack`` on the
CPU (the plain versions) against the reference package, bit for bit: the
packed index, the payload and ``n_live`` of ``zebra_pack``,
``compress``/``decompress``, ``compress_tree`` over a KV-cache-shaped tree
(run -> sub -> k/v, stacked and unstacked leaves, one leaf that cannot
compress), and the ``BandwidthMeter``'s records, totals, reconcile and
report."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import BandwidthMeter as JMeter
from repro.compress import compress as jcompress
from repro.compress import compress_tree as jcompress_tree
from repro.compress import decompress_tree as jdecompress_tree
from repro.compress import pack_bitmap as jpack_bitmap
from repro.compress import unpack_bitmap as junpack_bitmap
from repro.kernels.pack import zebra_pack as jzebra_pack
from repro_torch.compress import (BandwidthMeter, CompressedMap, compress, compress_tree,
                                  decompress, decompress_tree, nonzero_bitmap, pack_bitmap,
                                  unpack_bitmap)
from repro_torch.kernels.pack import zebra_pack

from _torch_parity import bits

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def masked_map(M, K, bs, bc, seed, live_p=0.5):
    """A Zebra-masked (M, K) map: dead blocks exact zeros, live blocks
    signed values (some exact zeros inside live blocks too)."""
    rng = np.random.default_rng(seed)
    live = rng.random((M // bs, 1, K // bc, 1)) < live_p
    x = np.where(live, rng.normal(size=(M // bs, bs, K // bc, bc)), 0.0)
    x[rng.random(x.shape) < 0.05] = 0.0
    return x.reshape(M, K).astype(np.float32)


@pytest.mark.parametrize("n", [1, 7, 8, 13, 64, 100])
def test_pack_bitmap_round_trip_matches_reference(n):
    rng = np.random.default_rng(n)
    bm = (rng.random((n, 3)) < 0.4).astype(np.int8)
    got = pack_bitmap(torch.from_numpy(bm))
    want = jpack_bitmap(jnp.asarray(bm))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), np.asarray(want))
    back = unpack_bitmap(got, n, 3)
    assert np.array_equal(back.numpy(), np.asarray(junpack_bitmap(want, n, 3))) and \
        np.array_equal(back.numpy(), bm)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", [(64, 512, 8, 128), (128, 64, 8, 64), (16, 256, 8, 128)])
def test_zebra_pack_matches_reference(shape, dt):
    """``zebra_pack`` under an external bitmap: payload (live blocks first
    in consumer order, zero tail) and n_live bitwise; a NaN and a -0.0 in
    live blocks travel as bits; a nonzero value in a dead block is not
    packed."""
    M, K, bs, bc = shape
    tdt, jdt = DTYPES[dt]
    x = masked_map(M, K, bs, bc, M + K)
    bitmap = np.asarray((np.abs(x.reshape(M // bs, bs, K // bc, bc)).max((1, 3)) > 0)
                        .astype(np.int8))
    live = np.argwhere(bitmap)
    x[live[0][0] * bs, live[0][1] * bc + 1] = np.nan
    x[live[-1][0] * bs + 1, live[-1][1] * bc] = -0.0
    ext = bitmap.copy()
    ext[tuple(live[1])] = 0                     # an external bitmap drops a live block
    xt, xj = torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)
    payload, n_live = zebra_pack(xt, torch.from_numpy(ext), bs=bs, bc=bc)
    jp, jn = jzebra_pack(xj, jnp.asarray(ext), bs=bs, bc=bc)
    assert int(n_live) == int(jn) == int(ext.sum())
    # NaN bit patterns: the CPU's bf16 rounding writes 0xFFFF (XLA 0x7FC0), so
    # NaNs compare as NaNs and every other bit exactly
    pn, jpn = payload.float().numpy(), np.asarray(jp, np.float32)
    assert np.array_equal(np.isnan(pn), np.isnan(jpn))
    keep = ~np.isnan(pn)
    assert np.array_equal(bits(payload)[keep], bits(jp)[keep])


@pytest.mark.parametrize("dt", list(DTYPES))
def test_compress_decompress_matches_reference(dt):
    tdt, jdt = DTYPES[dt]
    x = masked_map(64, 384, 8, 128, 5).reshape(2, 32, 384)
    cm = compress(torch.from_numpy(x).to(tdt))
    jcm = jcompress(jnp.asarray(x, jdt))
    assert isinstance(cm, CompressedMap)
    assert np.array_equal(bits(cm.payload), bits(jcm.payload))
    assert np.array_equal(cm.index.numpy(), np.asarray(jcm.index))
    for attr in ("n_blocks", "itemsize", "payload_bytes", "index_bytes", "measured_bytes",
                 "dense_bytes", "zero_frac"):
        a, b = getattr(cm, attr), getattr(jcm, attr)
        assert (a() if callable(a) else a) == (b() if callable(b) else b), attr
    assert cm.spec() == type(cm.spec())(**jcm.spec().__dict__)
    back = decompress(cm)
    assert tuple(back.shape) == x.shape and np.array_equal(bits(back),
                                                           bits(torch.from_numpy(x).to(tdt)))
    sealed = compress(torch.from_numpy(x).to(tdt), checksum=True)
    assert cm.checksum is None and jcm.checksum is None
    assert int(sealed.checksum) == int(np.uint32(jcompress(jnp.asarray(x, jdt),
                                                           checksum=True).checksum))
    assert np.array_equal(bits(sealed.payload), bits(cm.payload))


def kv_tree(dtype):
    """A KV-cache-shaped tree: a run of count 2 (stacked leaves), a run of
    count 1, a leaf whose width does not divide into blocks (moves dense)
    and a None (no encoder output)."""
    def kv(lead, T, H, hd, seed):
        shape = lead + (2, T, H, hd)
        n = int(np.prod(shape))
        m = masked_map(n // (H * hd), H * hd, 8, 128, seed) if (H * hd) % 128 == 0 \
            else np.random.default_rng(seed).normal(size=(n // (H * hd), H * hd))
        return m.reshape(shape).astype(np.float32)
    tree = [{"sub0": {"k": kv((2,), 16, 2, 320, 1), "v": kv((2,), 16, 2, 320, 2)},
             "sub1": {"k": kv((2,), 32, 2, 320, 3), "v": kv((2,), 32, 2, 320, 4)}},
            {"sub0": {"k": kv((), 16, 2, 48, 5), "v": kv((), 16, 2, 48, 6)}}]
    to_t = lambda a: torch.from_numpy(a).to(dtype[0])
    to_j = lambda a: jnp.asarray(a, dtype[1])
    return ([{s: {n: to_t(a) for n, a in kv_.items()} for s, kv_ in run.items()} for run in tree],
            [{s: {n: to_j(a) for n, a in kv_.items()} for s, kv_ in run.items()} for run in tree])


@pytest.mark.parametrize("dt", list(DTYPES))
def test_compress_tree_and_meter_match_reference(dt):
    tree, jtree = kv_tree(DTYPES[dt])
    meter, jmeter = BandwidthMeter(), JMeter()
    ctree = compress_tree(tree, bs=8, bc=128, meter=meter, site="kv")
    jctree = jcompress_tree(jtree, bs=8, bc=128, meter=jmeter, site="kv")
    assert [r.site for r in meter.records] == [r.site for r in jmeter.records]
    for r, jr in zip(meter.records, jmeter.records):
        assert (r.dense_bytes, r.payload_bytes, r.index_bytes, r.n_blocks, r.n_live) == \
            (jr.dense_bytes, jr.payload_bytes, jr.index_bytes, jr.n_blocks, jr.n_live)
        assert r.predicted_bytes == jr.predicted_bytes and r.zero_frac == jr.zero_frac
    assert meter.measured_bytes() == jmeter.measured_bytes() > 0
    assert meter.dense_bytes() == jmeter.dense_bytes()
    assert meter.measured_reduction_pct() == jmeter.measured_reduction_pct()
    assert meter.predicted_reduction_pct() == jmeter.predicted_reduction_pct()
    rec, jrec = meter.reconcile(), jmeter.reconcile()
    assert rec["n_sites"] == jrec["n_sites"] == 4
    assert rec["deltas"] == jrec["deltas"]
    assert meter.report() == jmeter.report()
    assert isinstance(ctree[0]["sub0"]["k"], CompressedMap)
    assert isinstance(ctree[1]["sub0"]["k"], torch.Tensor)        # 96 wide: dense
    back, jback = decompress_tree(ctree), jdecompress_tree(jctree)
    flat = lambda t: [t[r][s][n] for r in range(2) for s in sorted(t[r]) for n in ("k", "v")]
    for a, b, orig in zip(flat(back), flat(jback), flat(tree)):
        assert np.array_equal(bits(a), bits(b)) and torch.equal(a, orig)


def test_reconcile_raises_outside_the_band():
    meter = BandwidthMeter()
    cm = compress(torch.from_numpy(masked_map(16, 256, 8, 128, 1)))
    r = meter.record("x", cm)
    r.payload_bytes += 8                          # a stream longer than Eq. 2/3 allows
    with pytest.raises(AssertionError, match="index-padding"):
        meter.reconcile()


def test_nonzero_bitmap_matches_reference():
    from repro.compress import nonzero_bitmap as jnonzero
    x = masked_map(32, 256, 8, 128, 9)
    assert np.array_equal(nonzero_bitmap(torch.from_numpy(x), 8, 128).numpy(),
                          np.asarray(jnonzero(jnp.asarray(x), 8, 128)))
