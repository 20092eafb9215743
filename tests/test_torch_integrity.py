"""The port's stream-integrity contract (``repro_torch.compress.integrity``),
its validated engine path and serve's validated handoff, against the
reference (``repro.compress.integrity``, ``repro.core.engine``,
``repro.launch.serve``) on the same numpy inputs, on the CPU.

Bit for bit: the checksum word (as a uint32), every verdict and every
``CorruptStream`` message, the injected/detected/recovered counts of the
``BENCH_faults.json`` rows, the stream bytes and zero fractions, and every
output of the ``stream`` backend and of the serve handoff. ``fused``
outputs are allclose at 1e-4 (the recovery's float32 matmul and the
payload GEMM sum in different orders), as are logits (1e-4).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.compress import BandwidthMeter as JMeter
from repro.compress import CompressedMap as JCompressedMap
from repro.compress import compress_tree as jcompress_tree
from repro.compress import decompress_tree as jdecompress_tree
from repro.compress import integrity as jint
from repro.compress.stream import unpack_bitmap as junpack
from repro.core import ZebraConfig as JZebraConfig
from repro.core.engine import zebra_site as jsite
from repro.data import SYN_TINYIMAGENET as J_TINY
from repro.ft.faults import CorruptStream as JCorruptStream
from repro.launch import serve as jserve
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_generate, make_prefill
from repro.models.cnn import resnet18 as jax_resnet18
from repro.models.lm import LM as JLM
from repro.optim import sgd, step_decay
from repro.train.cnn_trainer import CNNTrainConfig as JTrainConfig
from repro.train.cnn_trainer import CNNTrainer as JTrainer
from repro_torch import configs
from repro_torch.compress import (CompressedMap, compress, compress_tree,
                                  decompress_tree)
from repro_torch.compress import integrity as tint
from repro_torch.compress.stream import unpack_bitmap as tunpack
from repro_torch.core import ZebraConfig
from repro_torch.core.engine import zebra_site
from repro_torch.data import SYN_TINYIMAGENET, LMDatasetConfig, image_batch, lm_batch
from repro_torch.ft.faults import CorruptStream
from repro_torch.launch import serve
from repro_torch.models.cnn.convert import from_jax_variables
from repro_torch.models.lm import LM
from repro_torch.models.lm.convert import from_jax_params
from repro_torch.train import CNNTrainConfig, CNNTrainer

from _torch_parity import bits

# the packages export a function ``inject`` under the module's own name
jinject = importlib.import_module("repro.ft.inject")
tinject = importlib.import_module("repro_torch.ft.inject")

# benchmarks/faults_bench.py's operating point
M, K, N, BS, BC = 256, 1024, 512, 8, 128
ENGINE_CASES = [("bitflip", "structural"), ("truncate", "structural"),
                ("nan", "structural"), ("count", "structural"), ("value", "checksum")]


def operating_x(seed: int) -> np.ndarray:
    """``faults_bench._operating_x``: an (M, K) f32 map whose blocks survive
    t_obj 0.5 at about 64 % zero blocks."""
    rng = np.random.default_rng(seed)
    keep = rng.random((M // BS, K // BC)) > 0.64
    x = rng.uniform(0.6, 1.0, size=(M, K)).astype(np.float32)
    x *= np.repeat(np.repeat(keep, BS, 0), BC, 1)
    return x


def fused_w() -> np.ndarray:
    """The fused rows' weight, from numpy (``jax.random`` has no torch
    counterpart), fed to both packages."""
    return (np.random.default_rng(2).normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)


def bits_t(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bit patterns, for bitwise torch comparisons."""
    return t.view(torch.int32)


def serve_dense() -> np.ndarray:
    """The serve rows' masked normal map (``default_rng(4)``)."""
    rng = np.random.default_rng(4)
    keep = rng.random((M // BS, K // BC)) > 0.64
    return (rng.normal(size=(M, K)).astype(np.float32)
            * np.repeat(np.repeat(keep, BS, 0), BC, 1))


# ---------------------------------------------------------------------------
# The checksum word
# ---------------------------------------------------------------------------

# raw words with the top bit set (negative values, -0.0, NaN patterns, -Inf)
_SPECIAL = {"f32": [0x80000000, 0x7FC00000, 0xFFFFFFFF, 0xFF800000, 0xFFC00001, 0xBF800000],
            "bf16": [0x8000, 0x7FC0, 0xFFFF, 0xFF80, 0xFFC1, 0xBF80],
            "f16": [0x8000, 0x7E00, 0xFFFF, 0xFC00, 0xFE01, 0xBC00]}
_VIEWS = {"f32": (np.uint32, np.float32, torch.int32, torch.float32),
          "bf16": (np.uint16, jnp.bfloat16, torch.int16, torch.bfloat16),
          "f16": (np.uint16, np.float16, torch.int16, torch.float16)}


def raw_payload(dt: str, nb: int, bs: int, bc: int, seed: int):
    """The same payload bits for both packages: (jax array, torch tensor)."""
    utype, jview, tint_dt, tdt = _VIEWS[dt]
    rng = np.random.default_rng(seed)
    words = rng.integers(0, np.iinfo(utype).max, size=(nb, bs, bc), dtype=np.uint64,
                         endpoint=True).astype(utype)
    flat = words.reshape(-1)
    n = min(len(_SPECIAL[dt]), flat.size)
    flat[:n] = _SPECIAL[dt][:n]
    flat[-1] = _SPECIAL[dt][0]          # -0.0 in the last slot too
    j = jnp.asarray(words.view(jview))
    t = torch.from_numpy(words.view({2: np.int16, 4: np.int32}[words.itemsize]).copy()
                         ).view(tdt)
    assert np.array_equal(np.asarray(j).view(utype), words)
    return j, t


@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("nb,bs,bc,n_live", [(7, 3, 5, 0), (7, 3, 5, 4), (7, 3, 5, 7),
                                             (16, 8, 128, 16), (12, 8, 8, 5), (1, 2, 2, 1)])
def test_stream_checksum_matches_reference(dt, nb, bs, bc, n_live):
    """Equal as a uint32 on float32, bfloat16 and float16 words with the
    top bit set, nb not a power of two, n_live 0 and n_live == nb."""
    j, t = raw_payload(dt, nb, bs, bc, nb * 100 + n_live)
    bitmap = (np.random.default_rng(nb).random((1, nb)) > 0.4).astype(np.int8)
    want = int(np.uint32(jint.stream_checksum(j, jnp.asarray(bitmap), jnp.int32(n_live))))
    got = tint.stream_checksum(t, torch.from_numpy(bitmap), torch.tensor(n_live))
    assert got.dtype == torch.int64 and int(got) == want


def test_stream_checksum_sees_what_structure_cannot():
    """One live word changed, two live slots swapped, or a dead slot's
    garbage: the fold moves on the first two, not on the third."""
    j, t = raw_payload("f32", 12, 8, 8, 1)
    t = torch.nan_to_num(t)
    bitmap = torch.ones(2, 6, dtype=torch.int8)
    base = int(tint.stream_checksum(t, bitmap, torch.tensor(8)))
    changed = t.clone()
    changed[3, 1, 2] += 1.0
    swapped = t.clone()
    swapped[[1, 2]] = t[[2, 1]]
    garbage = t.clone()
    garbage[10] = 7.0
    assert int(tint.stream_checksum(changed, bitmap, torch.tensor(8))) != base
    assert int(tint.stream_checksum(swapped, bitmap, torch.tensor(8))) != base
    assert int(tint.stream_checksum(garbage, bitmap, torch.tensor(8))) == base


# ---------------------------------------------------------------------------
# Verdicts and messages
# ---------------------------------------------------------------------------

def _packed(seed: int, dtype=torch.float32):
    """A compressed map of both packages from one numpy map."""
    x = operating_x(seed)[:64, :512]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcm = jcompress_tree({"k": jnp.asarray(x).astype(jdt)}, bs=BS, bc=BC, checksum=True)["k"]
    tcm = compress_tree({"k": torch.from_numpy(x).to(dtype)}, bs=BS, bc=BC,
                        checksum=True)["k"]
    return jcm, tcm


@pytest.mark.parametrize("level", ["off", "structural", "checksum"])
@pytest.mark.parametrize("kind", [None, *tinject.STREAM_KINDS])
def test_check_stream_matches_reference(kind, level):
    """The device verdict equals the reference's, for each corruption at
    each level (``value`` passes structural; everything passes off)."""
    jcm, tcm = _packed(0)
    jstream = (jcm.payload, junpack(jcm.index, 8, 4), jcm.n_live)
    tstream = (tcm.payload, tunpack(tcm.index, 8, 4), tcm.n_live)
    if kind is not None:
        with jinject.inject(jinject.Fault(kind, arg=3)):
            jstream = jinject.stream_tap(*jstream, site="s")
        with tinject.inject(tinject.Fault(kind, arg=3)):
            tstream = tinject.stream_tap(*tstream, site="s")
    want = bool(jint.check_stream(*jstream, level=level, checksum=jcm.checksum))
    got = tint.check_stream(*tstream, level=level, checksum=tcm.checksum)
    assert got.dtype == torch.bool and bool(got) == want
    assert want == (kind is None or level == "off" or (kind == "value" and level != "checksum"))


def _message(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except (CorruptStream, JCorruptStream) as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", ["clean", "ndim", "capacity", "n_live-range", "popcount",
                                  "non-finite", "all-zero", "no-checksum", "mismatch",
                                  "off"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_validate_payload_messages_match_reference(case, dt):
    """Each first failed invariant, named in the reference's words with
    the same slot index; a clean stream (and ``off``) raises nothing."""
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    jcm, tcm = _packed(1, dtype)
    jb = np.array(junpack(jcm.index, 8, 4))
    jp, tp = np.asarray(jcm.payload).copy(), tcm.payload.clone()
    nl, csum, level = int(jcm.n_live), int(np.uint32(jcm.checksum)), "checksum"
    tcsum = csum
    if case == "ndim":
        jp, tp = jp.reshape(jp.shape[0], -1), tp.reshape(tp.shape[0], -1)
    elif case == "capacity":
        jp, tp = jp[:-1], tp[:-1]
    elif case == "n_live-range":
        nl = jb.size + 1
    elif case == "popcount":
        nl -= 1
    elif case == "non-finite":
        jp[5, 2, 7] = np.nan
        tp[5, 2, 7] = float("nan")
    elif case == "all-zero":
        jp[2] = 0
        tp[2] = 0
    elif case == "no-checksum":
        csum = tcsum = None
    elif case == "mismatch":
        csum = tcsum = csum ^ 0x10
    elif case == "off":
        nl, level = nl + 5, "off"
    want = _message(jint.validate_payload, jnp.asarray(jp), jnp.asarray(jb), nl, level=level,
                    checksum=None if csum is None else np.uint32(csum), site="serve:leaf3")
    got = _message(tint.validate_payload, tp, torch.from_numpy(jb), torch.tensor(nl),
                   level=level, checksum=None if tcsum is None else torch.tensor(tcsum),
                   site="serve:leaf3")
    assert got == want
    assert (got is None) == (case in ("clean", "off"))


def test_compress_seals_with_the_reference_checksum():
    jcm, tcm = _packed(2, torch.bfloat16)
    assert int(tcm.checksum) == int(np.uint32(jcm.checksum))
    assert int(tint.map_checksum(tcm)) == int(tcm.checksum)
    assert compress(tcm.payload.new_zeros(16, 128), bs=8, bc=128).checksum is None
    tint.validate_map(tcm, level="checksum")
    jint.validate_map(jcm, level="checksum")


# ---------------------------------------------------------------------------
# The BENCH_faults.json rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", ["off", "structural", "checksum"])
def test_validate_rows_match_bench(level):
    """``faults/validate.<level>``: the stream at every level moves
    426016 bytes at zero_frac 0.5938, as the reference's."""
    x = operating_x(0)
    y, aux = zebra_site(torch.from_numpy(x), ZebraConfig(t_obj=0.5, mode="infer",
                                                         backend="stream", validation=level),
                        site="bench")
    jy, jaux = jsite(jnp.asarray(x), JZebraConfig(t_obj=0.5, mode="infer", backend="stream",
                                                  validation=level), site="bench")
    assert int(aux.measured_bytes) == int(jaux.measured_bytes) == 426016
    assert float(aux.zero_frac) == float(jaux.zero_frac)
    assert round(float(aux.zero_frac), 4) == 0.5938
    np.testing.assert_array_equal(bits(y), bits(np.asarray(jy)))


@pytest.mark.parametrize("kind,level", ENGINE_CASES)
@pytest.mark.parametrize("backend", ["stream", "fused"])
def test_engine_detection_rows_match_reference(backend, kind, level):
    """``faults/detect.{stream,fused}.<kind>``: one fault injected at
    ``engine:b``, detected once, recovered (stream bitwise to the clean
    run, fused allclose); outputs, bytes and zero fraction as the
    reference's."""
    x = operating_x(1)
    w = fused_w() if backend == "fused" else None
    tw = None if w is None else torch.from_numpy(w)
    jw = None if w is None else jnp.asarray(w)
    cfg = ZebraConfig(t_obj=0.5, mode="infer", backend=backend, validation=level)
    jcfg = JZebraConfig(t_obj=0.5, mode="infer", backend=backend, validation=level)
    clean, _ = zebra_site(torch.from_numpy(x), cfg, site="b", w=tw)
    tint.clear_failures()
    jint.clear_failures()
    with tinject.inject(tinject.Fault(kind, site="engine:b", arg=3)) as plan:
        y, aux = zebra_site(torch.from_numpy(x), cfg, site="b", w=tw)
    with jinject.inject(jinject.Fault(kind, site="engine:b", arg=3)) as jplan:
        jy, jaux = jsite(jnp.asarray(x), jcfg, site="b", w=jw)
        jax.block_until_ready(jy)
    jax.effects_barrier()
    assert len(plan.injected) == len(jplan.injected) == 1
    assert tint.failures() == jint.failures() == ["engine:b"]
    if backend == "stream":
        assert torch.equal(bits_t(y), bits_t(clean))
        np.testing.assert_array_equal(bits(y), bits(np.asarray(jy)))
    else:
        torch.testing.assert_close(y, clean, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    assert int(aux.measured_bytes) == int(jaux.measured_bytes)
    assert float(aux.zero_frac) == float(jaux.zero_frac)
    tint.clear_failures()


@pytest.mark.parametrize("kind,level", ENGINE_CASES)
def test_serve_detection_rows_match_reference(kind, level):
    """``faults/detect.serve.<kind>``: the handoff leaf corrupted at site
    ``serve`` is detected, and recovered from its dense source bit for
    bit, as in the reference."""
    dense = serve_dense()
    tdense = {"k": torch.from_numpy(dense)}
    jdense = {"k": jnp.asarray(dense)}
    ctree = compress_tree(tdense, bs=BS, bc=BC, checksum=(level == "checksum"))
    jctree = jcompress_tree(jdense, bs=BS, bc=BC, checksum=(level == "checksum"))
    with tinject.inject(tinject.Fault(kind, site="serve", arg=2)) as plan:
        out, n_bad = serve.validate_state_ingest(ctree, tdense, level, log=lambda *_: None)
    with jinject.inject(jinject.Fault(kind, site="serve", arg=2)) as jplan:
        jout, jn_bad = jserve.validate_state_ingest(jctree, jdense, level)
    assert len(plan.injected) == len(jplan.injected) == 1
    assert n_bad == jn_bad == 1
    assert not isinstance(out["k"], CompressedMap)
    np.testing.assert_array_equal(bits(decompress_tree(out)["k"]), bits(dense))
    np.testing.assert_array_equal(bits(np.asarray(jdecompress_tree(jout)["k"])), bits(dense))


def test_serve_ingest_trips_the_ambient_breaker_like_reference():
    """The handoff as a breaker boundary, under ``breaker_scope``: a
    corrupt leaf trips the site (trip_after 1), the next handoffs go dense
    wholesale while it is open, the half-open probe passes and closes it;
    the recovered counts, the leaves' forms and the board's snapshot after
    each handoff equal the reference's."""
    import repro.ft.breaker as jbreaker
    import repro_torch.ft.breaker as tbreaker
    dense = serve_dense()
    tdense = {"a": torch.from_numpy(dense), "b": torch.from_numpy(dense[::-1].copy())}
    jdense = {k: jnp.asarray(v.numpy()) for k, v in tdense.items()}
    cfg = dict(trip_after=1, probe_after=2, close_after=1)
    tboard = tbreaker.BreakerBoard(tbreaker.BreakerConfig(**cfg))
    jboard = jbreaker.BreakerBoard(jbreaker.BreakerConfig(**cfg))
    for call in range(5):
        faults = [("nan", "serve", 1)] if call == 0 else []
        with tbreaker.breaker_scope(tboard), \
                tinject.inject(*[tinject.Fault(*f) for f in faults]):
            out, n_bad = serve.validate_state_ingest(
                compress_tree(tdense, bs=BS, bc=BC), tdense, "structural",
                log=lambda *_: None)
        with jbreaker.breaker_scope(jboard), \
                jinject.inject(*[jinject.Fault(*f) for f in faults]):
            jout, jn_bad = jserve.validate_state_ingest(
                jcompress_tree(jdense, bs=BS, bc=BC), jdense, "structural")
        assert n_bad == jn_bad == (1 if call == 0 else 0)
        assert [isinstance(out[k], CompressedMap) for k in "ab"] == \
            [isinstance(jout[k], JCompressedMap) for k in "ab"]
        assert tboard.snapshot() == jboard.snapshot() and tboard.now == jboard.now
        for k in "ab":      # by value: a dead block's -0.0 comes back as +0
            np.testing.assert_array_equal(decompress_tree(out)[k].numpy(), tdense[k].numpy())
    assert tboard.trips == 1 and tboard.get("serve").state == "closed"


def test_value_needs_the_checksum_level_and_off_is_the_identity():
    """A ``value`` fault passes structural undetected in both packages (the
    same corrupted output); at ``off`` no tap is on the path, and the
    checks pass anything."""
    x = torch.from_numpy(operating_x(1))
    cfg = ZebraConfig(t_obj=0.5, mode="infer", backend="stream", validation="structural")
    clean, _ = zebra_site(x, cfg, site="b")
    tint.clear_failures()
    jint.clear_failures()
    with tinject.inject(tinject.Fault("value", site="engine:b", arg=3)) as plan:
        y, _ = zebra_site(x, cfg, site="b")
    with jinject.inject(jinject.Fault("value", site="engine:b", arg=3)):
        jy, _ = jsite(jnp.asarray(x.numpy()), JZebraConfig(t_obj=0.5, mode="infer",
                                                           backend="stream",
                                                           validation="structural"),
                      site="b")
    assert len(plan.injected) == 1 and tint.failures() == jint.failures() == []
    assert int((y != clean).sum()) == 1
    np.testing.assert_array_equal(bits(y), bits(np.asarray(jy)))
    off = cfg.replace(validation="off")
    with tinject.inject(tinject.Fault("bitflip", site="*")) as plan:
        y_off, _ = zebra_site(x, off, site="b")
    assert plan.injected == [] and torch.equal(bits_t(y_off), bits_t(clean))
    payload = torch.full((4, 2, 2), float("nan"))
    assert bool(tint.check_stream(payload, torch.zeros(2, 2, dtype=torch.int8),
                                  torch.tensor(9), level="off"))
    tint.validate_payload(payload, torch.zeros(2, 2), torch.tensor(9), level="off")


@pytest.mark.parametrize("level", ["structural", "checksum"])
def test_validated_fused_site_without_w_moves_stream_bytes(level):
    """A validated ``fused`` site with no weight (the LM's ``kv_cache``)
    runs comparator + pack -> check -> expander: nonzero stream bytes,
    equal to the reference's, and the reference's map bit for bit (the
    expander's +0 in dead blocks); by value it is the unvalidated masking
    pass's map."""
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(2, 64, 256)) * rng.uniform(0, 2, size=(2, 8, 1, 2, 1))
         .repeat(8, 2).repeat(128, 4).reshape(2, 64, 256)).astype(np.float32)
    cfg = ZebraConfig(t_obj=1.0, mode="infer", backend="fused", validation=level)
    y, aux = zebra_site(torch.from_numpy(x), cfg, site="kv_cache")
    jy, jaux = jsite(jnp.asarray(x), JZebraConfig(t_obj=1.0, mode="infer", backend="fused",
                                                  validation=level), site="kv_cache")
    assert int(aux.measured_bytes) == int(jaux.measured_bytes) > 0
    assert float(aux.zero_frac) == float(jaux.zero_frac) and 0 < float(aux.zero_frac) < 1
    np.testing.assert_array_equal(bits(y), bits(np.asarray(jy)))
    y_off, aux_off = zebra_site(torch.from_numpy(x), cfg.replace(validation="off"),
                                site="kv_cache")
    assert int(aux_off.measured_bytes) == 0 and bool((y == y_off).all())
    assert not torch.equal(bits_t(y), bits_t(y_off))          # -0.0 vs +0 in dead blocks


# ---------------------------------------------------------------------------
# The slices at reduced size
# ---------------------------------------------------------------------------

def test_reduced_resnet18_validated_evaluate_matches_reference():
    """ResNet-18 (width 1/8) evaluate on ``stream`` at ``checksum``: the
    reference's bytes, accuracy and zero fractions; the port's logits and
    per-site bytes equal its own ``off`` run's bit for bit; no failure."""
    zkw = dict(mode="infer", backend="stream", block_hw=8, t_obj=1.5)
    jmodel = jax_resnet18(200, 64, width_mult=0.125)
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    jtr = JTrainer(JTrainConfig(model="resnet18", width_mult=0.125, dataset=J_TINY,
                                zebra=JZebraConfig(interpret=True, validation="checksum",
                                                   **zkw)),
                   sgd(step_decay(0.05, total_steps=1)))
    jint.clear_failures()
    jout = jtr.evaluate(jvars, batches=1, batch=2)
    tr = CNNTrainer(CNNTrainConfig(model="resnet18", width_mult=0.125,
                                   dataset=SYN_TINYIMAGENET,
                                   zebra=ZebraConfig(validation="checksum", **zkw)),
                    device="cpu")
    variables = from_jax_variables(tr.model, jax.tree_util.tree_map(np.asarray, jvars)
                                   ).state_dict()
    tint.clear_failures()
    out = tr.evaluate(variables, batches=1, batch=2)
    assert out["measured_bytes"] == jout["measured_bytes"] > 0
    assert out["acc"] == jout["acc"] and out["top5"] == jout["top5"]
    np.testing.assert_array_equal(out["site_zero_fracs"], jout["site_zero_fracs"])
    images = torch.from_numpy(image_batch(SYN_TINYIMAGENET, 2, 10_000)[0])
    logits, auxes = tr.forward(variables, images)
    logits_off, auxes_off = tr.forward(variables, images,
                                       tr.cfg.zebra.replace(validation="off"))
    assert torch.equal(bits_t(logits), bits_t(logits_off))
    assert [int(a.measured_bytes) for a in auxes] == [int(a.measured_bytes) for a in auxes_off]
    assert tint.failures() == jint.failures() == []


B, S, GEN = 2, 32, 3


def test_reduced_serve_validate_checksum_matches_reference():
    """Reduced gemma3-4b (6 layers) served on ``fused`` at ``checksum``
    with two faults armed, a bitmap bit of the first ``kv_cache`` stream
    and a live value of the first handoff leaf: both detected and
    recovered in both packages; logits at 1e-4, tokens equal, the
    handoff's meter bytes exact, the same leaf handed over dense."""
    kw = dict(param_dtype="float32", compute_dtype="float32",
              zebra_sites=("ffn_hidden", "kv_cache"), zebra_t_obj=2.45,
              zebra_backend="fused", zebra_validation="checksum")
    jcfg = jconfigs.reduced("gemma3-4b").replace(**kw)
    tcfg = configs.reduced("gemma3-4b").replace(**kw)
    faults = [("bitflip", "engine:kv_cache", 3), ("value", "serve", 2)]
    jmodel = JLM(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    mesh = make_host_mesh(model=1)
    prompts = np.asarray(lm_batch(LMDatasetConfig(vocab=jcfg.vocab), B, S, 0)[:, :S])
    jint.clear_failures()
    with jinject.inject(*[jinject.Fault(k, site=s, arg=a) for k, s, a in faults]) as jplan:
        jlogits, jstate, _ = jserve.model_prefill_pad(jax.jit(make_prefill(jmodel, mesh)),
                                                      params, jnp.asarray(prompts), S + GEN)
        jax.block_until_ready(jlogits)
        jax.effects_barrier()
        jhandoff = jserve.transport_state_compressed(jstate, jcfg, validation="checksum")
    jmeter = JMeter()
    jcompress_tree(jstate[0], bs=8, bc=128, meter=jmeter, site="kv")
    tok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)[:, None]
    jtoks, _ = jax.jit(make_generate(jmodel, mesh, GEN - 1))(params, tok, jhandoff,
                                                             jnp.int32(S))
    jtokens = np.concatenate([np.asarray(tok), np.asarray(jtoks)], 1)

    model = from_jax_params(LM(tcfg), jax.tree_util.tree_map(np.asarray, params))
    tint.clear_failures()
    with tinject.inject(*[tinject.Fault(k, site=s, arg=a) for k, s, a in faults]) as plan:
        out = serve.serve_one_shot(model.requires_grad_(False),
                                   torch.from_numpy(prompts).long(), GEN,
                                   log=lambda *_: None)
    assert plan.injected == jplan.injected == [("bitflip", "engine:kv_cache"),
                                               ("value", "serve")]
    assert tint.failures() == jint.failures() == ["engine:kv_cache"]
    assert out["ingest_recovered"] == 1
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jlogits), rtol=1e-4,
                               atol=1e-4)
    assert np.array_equal(out["tokens"].numpy(), jtokens)
    meter = out["meter"]
    assert [(r.site, r.payload_bytes, r.index_bytes, r.n_live) for r in meter.records] == \
        [(r.site, r.payload_bytes, r.index_bytes, r.n_live) for r in jmeter.records]
    t_kinds = [isinstance(l, CompressedMap) for l in serve._leaves(out["handoff_state"][0])]
    j_kinds = [isinstance(l, JCompressedMap) for l in jax.tree_util.tree_leaves(
        jhandoff[0], is_leaf=lambda l: isinstance(l, JCompressedMap))]
    assert t_kinds == j_kinds and t_kinds.count(False) == 1
    tint.clear_failures()
    jint.clear_failures()
