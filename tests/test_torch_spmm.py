"""The port's payload GEMM (``zebra_spmm_cs``), its dense twin
(``zebra_spmm``) and the engine's ``fused`` site, on the CPU (the plain
versions), against the reference package's realizations: the scheduled
XLA form and the Pallas kernel forms in interpret mode.

Tolerance: the reference's forms and the port sum the fp32 products in
different orders, so GEMM outputs are allclose at rtol 1e-5 / atol 1e-5
(fp32 accumulate of values of order 1 over K <= 1024; bf16 inputs are
exact in fp32, so the same bound holds). The bitmap, ``n_live``, the
payload and the stream bytes are bitwise. Within the port, plain
spmm_cs == plain zebra_spmm bit for bit (one float32 operand, one matmul).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import zebra_site as jax_site
from repro.core.zebra import ZebraConfig as JZebraConfig
from repro.kernels.mask_pack import zebra_mask_pack as jax_mask_pack
from repro.kernels.spmm_cs import zebra_spmm_cs as jax_spmm_cs
from repro.kernels.zebra_spmm import zebra_spmm as jax_spmm
from repro_torch.core.engine import wants_fused, zebra_site
from repro_torch.core.zebra import ZebraConfig
from repro_torch.kernels.mask_pack import zebra_mask_pack
from repro_torch.kernels.schedule import slot_map
from repro_torch.kernels.spmm_cs import spmm_cs_plain, zebra_spmm_cs
from repro_torch.kernels.zebra_spmm import (MAX_BF16_NK, aligned16, check_cuda_gemm,
                                            spmm_plain, split_rows, sub_rows, zebra_spmm)

from _torch_parity import bits

RTOL = ATOL = 1e-5
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def token_map(M, K, bs, bc, seed, kind="mixed"):
    """A signed (M, K) map whose blocks are scaled so some fall under T_obj
    1.0; ``kind`` forces all blocks dead or live, or one live block per
    K-block column."""
    rng = np.random.default_rng(seed)
    nm, nk = M // bs, K // bc
    scale = rng.uniform(0.0, 2.0, size=(nm, 1, nk, 1))
    if kind == "all-dead":
        scale[:] = 0.1
    elif kind == "all-live":
        scale[:] = 3.0
    elif kind == "one-per-column":
        scale[:] = 0.1
        scale[rng.integers(0, nm, size=nk), 0, np.arange(nk), 0] = 3.0
    x = rng.normal(size=(nm, bs, nk, bc)) * scale
    return x.reshape(M, K).astype(np.float32)


def weight(K, N, seed):
    return (np.random.default_rng(seed).normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)


CASES = {
    # label: (M, K, N, bs, bc, kind)
    "8x128": (64, 512, 96, 8, 128, "mixed"),
    "8x64-whole-width": (64, 64, 40, 8, 64, "mixed"),
    "all-dead": (32, 256, 64, 8, 128, "all-dead"),
    "all-live": (32, 256, 64, 8, 128, "all-live"),
    "one-per-column": (64, 512, 64, 8, 128, "one-per-column"),
}


# every case in float32, the two block shapes in bfloat16 too
CASE_DTYPES = [(c, "f32") for c in CASES] + [("8x128", "bf16"), ("8x64-whole-width", "bf16")]


def _stream(case, dt):
    M, K, N, bs, bc, kind = CASES[case]
    tdt, jdt = DTYPES[dt]
    x = token_map(M, K, bs, bc, len(case), kind)
    w = weight(K, N, 7)
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    payload, bitmap, n_live = zebra_mask_pack(xt, t_obj=1.0, bs=bs, bc=bc)
    jp, jb, jn = jax_mask_pack(xj, t_obj=1.0, bs=bs, bc=bc)
    assert np.array_equal(bits(payload), bits(jp)) and np.array_equal(bits(bitmap), bits(jb))
    assert int(n_live) == int(jn)
    return (xt, wt, payload, bitmap), (xj, wj, jp, jb), (bs, bc)


@pytest.mark.parametrize("case,dt", CASE_DTYPES)
def test_spmm_cs_matches_both_jax_realizations(case, dt):
    (xt, wt, payload, bitmap), (xj, wj, jp, jb), (bs, bc) = _stream(case, dt)
    got = zebra_spmm_cs(payload, wt, bitmap, bs=bs, bc=bc)
    assert got.dtype == torch.float32
    for form in ({"scheduled": True}, {"scheduled": False, "payload_windows": True}):
        want = np.asarray(jax_spmm_cs(jp, wj, jb, bs=bs, bc=bc, **form))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL, err_msg=str(form))
    if case == "all-dead":
        assert not got.any()


@pytest.mark.parametrize("case,dt", CASE_DTYPES)
def test_zebra_spmm_matches_jax_and_plain_spmm_cs_bitwise(case, dt):
    (xt, wt, payload, bitmap), (xj, wj, jp, jb), (bs, bc) = _stream(case, dt)
    got = zebra_spmm(xt, wt, bitmap, bs=bs, bc=bc)
    for scheduled in (True, False):
        want = np.asarray(jax_spmm(xj, wj, jb, bs=bs, bc=bc, scheduled=scheduled))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    keep, slot = slot_map(bitmap)
    assert torch.equal(bits_t(got), bits_t(spmm_cs_plain(payload, wt, bitmap, keep, slot, bs, bc)))
    assert torch.equal(bits_t(got), bits_t(spmm_plain(xt, wt, bitmap, bs, bc)))


def bits_t(t):
    return t.view(torch.int32)


def test_dead_blocks_never_leak_from_the_map_or_an_aliased_slot():
    """Dead blocks are exact zeros in both consumers whatever x holds (NaN,
    Inf), and a dead block's slot, which aliases a live one, is never used."""
    M, K, N, bs, bc = 32, 256, 16, 8, 128
    x = torch.from_numpy(token_map(M, K, bs, bc, 3))
    payload, bitmap, _ = zebra_mask_pack(x, t_obj=1.0, bs=bs, bc=bc)
    w = torch.from_numpy(weight(K, N, 1))
    poisoned = x.clone()
    dead = (bitmap == 0).nonzero()[0]
    poisoned[dead[0] * bs, dead[1] * bc] = float("nan")
    poisoned[dead[0] * bs + 1, dead[1] * bc] = float("inf")
    clean = zebra_spmm(x, w, bitmap, bs=bs, bc=bc)
    assert torch.equal(zebra_spmm(poisoned, w, bitmap, bs=bs, bc=bc), clean)
    assert torch.equal(zebra_spmm_cs(payload, w, bitmap, bs=bs, bc=bc), clean)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_fused_site_matches_reference_engine(dt):
    """The engine's fused site with w (mask_pack -> payload GEMM) against
    the reference package's: y allclose, bitmap-derived observables exact;
    the bare 2-D map passes w through; train mode degrades."""
    tdt, jdt = DTYPES[dt]
    B, S, D, N = 2, 16, 512, 64
    h = token_map(B * S, D, 8, 128, 11).reshape(B, S, D)
    w = weight(D, N, 5)
    cfg = ZebraConfig(mode="infer", backend="fused", t_obj=1.0)
    jcfg = JZebraConfig(mode="infer", backend="fused", t_obj=1.0)
    ht, wt = torch.from_numpy(h).to(tdt), torch.from_numpy(w).to(tdt)
    hj, wj = jnp.asarray(h, jdt), jnp.asarray(w, jdt)
    y, aux = zebra_site(ht, cfg, site="ffn_hidden", w=wt)
    jy, jaux = jax_site(hj, jcfg, site="ffn_hidden", w=wj)
    assert y.dtype == tdt and tuple(y.shape) == (B, S, N)
    tol = 1e-5 if dt == "f32" else 1e-2        # y is rounded to the map's dtype
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32), rtol=tol, atol=tol)
    assert aux.backend == jaux.backend == "fused"
    assert int(aux.measured_bytes) == int(jaux.measured_bytes) > 0
    assert np.array_equal(bits(aux.zero_frac), bits(jaux.zero_frac))
    assert 0.0 < float(aux.zero_frac) < 1.0
    y2, aux2 = zebra_site(ht[0], cfg, site="ffn_hidden", w=wt)
    jy2, _ = jax_site(hj[0], jcfg, site="ffn_hidden", w=wj)
    np.testing.assert_allclose(y2.float().numpy(), np.asarray(jy2, np.float32), rtol=tol, atol=tol)
    # the w-less fused site is the pallas masking pass: the masked map, no bytes
    ym, auxm = zebra_site(ht, cfg, site="kv_cache")
    jym, jauxm = jax_site(hj, jcfg, site="kv_cache")
    assert np.array_equal(bits(ym), bits(jym)) and int(auxm.measured_bytes) == 0
    assert wants_fused(cfg, "ffn_hidden")
    assert not wants_fused(cfg.replace(mode="train", use_tnet=False), "ffn_hidden")
    yt, auxt = zebra_site(ht, cfg.replace(mode="train", use_tnet=False), w=wt)
    assert auxt.backend == "reference(not-trainable)" and tuple(yt.shape) == (B, S, N)


def test_fused_degenerate_rows_take_the_masked_dense_matmul():
    """A one-token map (decode) has S % block_seq != 0: the site degrades
    to reference with ``y @ w`` and launches no GEMM."""
    h = torch.from_numpy(token_map(8, 256, 8, 128, 2))[:2].reshape(2, 1, 256)
    w = torch.from_numpy(weight(256, 32, 3))
    cfg = ZebraConfig(mode="infer", backend="fused", t_obj=1.0)
    before = (zebra_spmm.launches, zebra_spmm_cs.launches)
    y, aux = zebra_site(h, cfg, site="ffn_hidden", w=w)
    jy, jaux = jax_site(jnp.asarray(h.numpy()), JZebraConfig(mode="infer", backend="fused",
                                                           t_obj=1.0), site="ffn_hidden",
                        w=jnp.asarray(w.numpy()))
    assert aux.backend == jaux.backend == "reference(degenerate-rows)"
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    assert (zebra_spmm.launches, zebra_spmm_cs.launches) == before


# ---------------------------------------------------------------------------
# The CUDA GEMM wrappers' rules (checked before a launch; no card needed)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
def test_cuda_gemm_rules_take_every_bs_up_to_8(dt):
    """Every bs up to 8, and every larger bs (run as ``sub_rows(bs)``-row
    sub-blocks); bs 0 is refused before a launch."""
    tdt = DTYPES[dt][0]
    bitmap = torch.ones(4, 2, dtype=torch.int8)
    w = torch.zeros(2 * 128, 16, dtype=tdt)
    for bs in (*range(1, 13), 16, 20, 24, 64):
        check_cuda_gemm(w, bitmap, bs, 128, "zebra_spmm")
    with pytest.raises(ValueError, match="bs >= 1"):
        check_cuda_gemm(w, bitmap, 0, 128, "zebra_spmm")
    assert [sub_rows(bs) for bs in (1, 8, 9, 11, 12, 16, 20, 24)] == [1, 8, 3, 1, 6, 8, 5, 8]


def test_cuda_gemm_rules_refuse_float16():
    """float16 runs the tensor-core body, so it is refused where bfloat16
    is: a block row of bc % 8 != 0 elements, or more K-block columns than
    shared memory holds. Other dtypes have no GEMM body."""
    half = torch.zeros(256, 16, dtype=torch.float16)
    check_cuda_gemm(half, torch.ones(4, 2, dtype=torch.int8), 8, 128, "zebra_spmm")
    with pytest.raises(ValueError, match="multiple of 8"):
        check_cuda_gemm(torch.zeros(240, 16, dtype=torch.float16),
                        torch.ones(4, 20, dtype=torch.int8), 8, 12, "zebra_spmm")
    with pytest.raises(ValueError, match="K-block columns"):
        check_cuda_gemm(half, torch.ones(1, MAX_BF16_NK + 1, dtype=torch.int8), 8, 8,
                        "zebra_spmm")
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        check_cuda_gemm(half.double(), torch.ones(4, 2, dtype=torch.int8), 8, 128,
                        "zebra_spmm")


@pytest.mark.parametrize("bs,dt", [(16, "f32"), (16, "bf16"), (24, "f32")])
def test_split_rows_runs_bs_8j_as_8_row_sub_blocks(bs, dt):
    """The pieces ``split_rows`` derives for bs = 8j give, through the bs-8
    plain version on the payload viewed as (j*nb, 8, bc), the bs GEMM bit
    for bit, in both forms; the sub-block slots address the same memory."""
    tdt = DTYPES[dt][0]
    M, K, N, bc = 4 * bs, 512, 48, 128
    x = torch.from_numpy(token_map(M, K, bs, bc, bs)).to(tdt)
    w = torch.from_numpy(weight(K, N, 2)).to(tdt)
    payload, bitmap, _ = zebra_mask_pack(x, t_obj=1.0, bs=bs, bc=bc)
    keep, slot = slot_map(bitmap)
    assert 0 < int(keep.sum()) < keep.numel()
    bitmap8, slot8 = split_rows(bitmap, slot, bs)
    keep8, _ = slot_map(bitmap8)
    assert tuple(bitmap8.shape) == (M // 8, K // bc) and slot8.dtype == slot.dtype
    payload8 = payload.reshape(-1, 8, bc)
    want = spmm_cs_plain(payload, w, bitmap, keep, slot, bs, bc)
    got = spmm_cs_plain(payload8, w, bitmap8, keep8, slot8, 8, bc)
    assert torch.equal(bits_t(got), bits_t(want))
    assert torch.equal(bits_t(spmm_plain(x, w, split_rows(bitmap, None, bs)[0], 8, bc)),
                       bits_t(spmm_plain(x, w, bitmap, bs, bc)))
    live = keep8 != 0                   # each live sub-block's slot holds its rows
    xb = x.reshape(M // 8, 8, K // bc, bc).permute(0, 2, 1, 3).reshape(-1, 8, bc)
    assert torch.equal(payload8[slot8[live].long()], xb[live])


@pytest.mark.parametrize("bs,dt", [(12, "f32"), (12, "bf16"), (9, "f32"), (11, "bf16"),
                                   (24, "bf16")])
def test_split_rows_runs_other_bs_as_sub_row_blocks(bs, dt):
    """A bs that is not 8·j runs as j sub-blocks of ``r = sub_rows(bs)``
    rows (bs 12: two 6-row halves; 9: three of 3; 11: eleven of 1; 24:
    three of 8): through the r-row plain version on the payload viewed as
    (j*nb, r, bc), the pieces ``split_rows`` derives give the bs GEMM bit
    for bit in both forms, and each live sub-block's slot holds its rows."""
    tdt = DTYPES[dt][0]
    r = sub_rows(bs)
    M, K, N, bc = 4 * bs, 512, 48, 128
    x = torch.from_numpy(token_map(M, K, bs, bc, bs)).to(tdt)
    w = torch.from_numpy(weight(K, N, 3)).to(tdt)
    payload, bitmap, _ = zebra_mask_pack(x, t_obj=1.0, bs=bs, bc=bc)
    keep, slot = slot_map(bitmap)
    assert 0 < int(keep.sum()) < keep.numel()
    bitmap_r, slot_r = split_rows(bitmap, slot, bs)
    keep_r, _ = slot_map(bitmap_r)
    assert tuple(bitmap_r.shape) == (M // r, K // bc) and slot_r.dtype == slot.dtype
    payload_r = payload.reshape(-1, r, bc)
    want = spmm_cs_plain(payload, w, bitmap, keep, slot, bs, bc)
    got = spmm_cs_plain(payload_r, w, bitmap_r, keep_r, slot_r, r, bc)
    assert torch.equal(bits_t(got), bits_t(want))
    assert torch.equal(bits_t(spmm_plain(x, w, split_rows(bitmap, None, bs)[0], r, bc)),
                       bits_t(spmm_plain(x, w, bitmap, bs, bc)))
    live = keep_r != 0
    xb = x.reshape(M // r, r, K // bc, bc).permute(0, 2, 1, 3).reshape(-1, r, bc)
    assert torch.equal(payload_r[slot_r[live].long()], xb[live])


@pytest.mark.parametrize("x_dt", ["bf16", "f32"])
def test_fused_site_promotes_a_weight_of_another_dtype(x_dt):
    """A fused site whose weight has another dtype than the map: both
    operands promote as ``jnp.dot`` promotes them (bf16 map, f32 weight:
    f32 products of the unrounded weight), the output comes back in the
    map's dtype, and the stream bytes are the map's; the dense reference
    site returns the promoted product, as the reference's does."""
    tdt, jdt = DTYPES[x_dt]
    w_dt = "f32" if x_dt == "bf16" else "bf16"
    h = np.random.default_rng(1).normal(size=(1, 16, 256)).astype(np.float32)
    w = weight(256, 64, 2) * 16.0
    wt, wj = torch.from_numpy(w).to(DTYPES[w_dt][0]), jnp.asarray(w, DTYPES[w_dt][1])
    cfg = dict(mode="infer", t_obj=0.5)
    y, aux = zebra_site(torch.from_numpy(h).to(tdt), ZebraConfig(backend="fused", **cfg),
                        site="ffn_hidden", w=wt)
    jy, jaux = jax_site(jnp.asarray(h, jdt), JZebraConfig(backend="fused", **cfg),
                        site="ffn_hidden", w=wj)
    assert y.dtype == tdt and str(jy.dtype) == str(jnp.dtype(jdt))
    want_bytes = 8193 if x_dt == "bf16" else 16385     # 4 live 8x128 blocks + index
    assert int(aux.measured_bytes) == int(jaux.measured_bytes) == want_bytes
    assert np.array_equal(bits(aux.zero_frac), bits(jaux.zero_frac))
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32), rtol=1e-2,
                               atol=1e-2)
    if x_dt == "bf16":                  # not the product of a bf16-rounded weight
        rounded = torch.from_numpy(h).bfloat16().float() @ wt.bfloat16().float()
        assert not torch.equal(y, rounded.bfloat16().reshape(y.shape))
    yr, _ = zebra_site(torch.from_numpy(h).to(tdt), ZebraConfig(backend="reference", **cfg),
                       site="ffn_hidden", w=wt)
    jyr, _ = jax_site(jnp.asarray(h, jdt), JZebraConfig(backend="reference", **cfg),
                      site="ffn_hidden", w=wj)
    assert yr.dtype == torch.float32 and str(jyr.dtype) == "float32"
    np.testing.assert_allclose(yr.numpy(), np.asarray(jyr), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bc", [4, 12, 20, 100, 130])
def test_cuda_gemm_rules_refuse_bf16_blocks_not_a_multiple_of_8(bc):
    """The bfloat16 kernel stages a block column as 16-byte rows; float32
    (the CUDA-core body) takes any bc."""
    bitmap = torch.ones(4, 2, dtype=torch.int8)
    w = torch.zeros(2 * bc, 16)
    with pytest.raises(ValueError, match="multiple of 8"):
        check_cuda_gemm(w.to(torch.bfloat16), bitmap, 8, bc, "zebra_spmm_cs")
    check_cuda_gemm(w, bitmap, 8, bc, "zebra_spmm_cs")
    check_cuda_gemm(torch.zeros(2 * 24, 16, dtype=torch.bfloat16), bitmap, 8, 24,
                    "zebra_spmm_cs")


def test_cuda_gemm_rules_bound_the_bf16_keep_map_table():
    w = torch.zeros(8 * (MAX_BF16_NK + 1), 8, dtype=torch.bfloat16)
    check_cuda_gemm(w[:8 * MAX_BF16_NK], torch.ones(1, MAX_BF16_NK, dtype=torch.int8), 8, 8,
                    "zebra_spmm")
    with pytest.raises(ValueError, match="K-block columns"):
        check_cuda_gemm(w, torch.ones(1, MAX_BF16_NK + 1, dtype=torch.int8), 8, 8,
                        "zebra_spmm")
    check_cuda_gemm(w.float(), torch.ones(1, MAX_BF16_NK + 1, dtype=torch.int8), 8, 8,
                    "zebra_spmm")


def test_aligned16_copies_only_a_misaligned_start():
    """cp.async moves 16 bytes: a tensor whose data starts off a 16-byte
    boundary is copied (same values), any other is passed through."""
    base = torch.arange(40, dtype=torch.bfloat16)
    assert aligned16(base).data_ptr() == base.data_ptr()
    view = base[8:]                             # 16 bytes in: still aligned
    assert aligned16(view).data_ptr() == view.data_ptr()
    odd = base[1:]
    got = aligned16(odd)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, odd)
