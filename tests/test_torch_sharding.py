"""The port's sharding rules (``repro_torch.distributed.sharding``), its
distributed context and the single-process pieces of the collectives
slice, against the reference, in process.

The reference's ``spec_for``, ``batch_spec`` and ``cache_spec_for`` read
only ``mesh.shape`` and ``mesh.axis_names``, so a stand-in object serves
as the (data 4, model 2) mesh of ``tests/test_sharding_spec.py``. Held
exactly: every parameter's and cache leaf's spec over the ten reduced
configs under the "tp" and "dp" profiles (the port keeps one module a
layer: its spec is the reference's without the stacked run's leading
None), the written assertions of ``test_sharding_spec.py``,
``resolve_comms``'s four degrade reasons, ``attach_link``'s label,
``merge_site_aux``'s ici legs and zero fraction (against the jitted
reference), ``LayerAux``'s ici totals past 16 MiB and the meter's link
records against the reference meter's.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.compress.meter import BandwidthMeter as JMeter
from repro.core.engine import LayerAux as JLayerAux
from repro.core.engine import SiteAux as JSiteAux
from repro.core.engine import merge_site_aux as jmerge
from repro.distributed import collectives as jcoll
from repro.distributed import sharding as jsh
from repro.models.lm import LM as JLM
from repro_torch import configs
from repro_torch.compress.meter import BandwidthMeter
from repro_torch.core.engine import LayerAux, SiteAux, merge_site_aux
from repro_torch.core.zebra import ZebraConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.ctx import comm_context
from repro_torch.ft import BreakerBoard, BreakerConfig, Fault, breaker_scope, inject
from repro_torch.ft.inject import ring_hop_tap
from repro_torch.launch.mesh import batch_axes
from repro_torch.models.lm import LM
from repro_torch.models.lm.attention import gather_kv_shards
from repro_torch.models.lm.ffn import ffn_layer_out_exchange

from _torch_parity import bits

MESH = types.SimpleNamespace(shape={"data": 4, "model": 2}, axis_names=("data", "model"))
BS, BC = 8, 128


def as_list(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]


def _names(path) -> tuple[str, ...]:
    return tuple(str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p))))
                 for p in path)


@pytest.mark.parametrize("profile", ["tp", "dp"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_specs_match_reference_leaf_by_leaf(arch, profile):
    jcfg = jconfigs.reduced(arch).replace(sharding_profile=profile)
    tcfg = configs.reduced(arch).replace(sharding_profile=profile)
    model = LM(tcfg, generator=torch.Generator().manual_seed(0))
    port = sh.param_specs(model, tcfg, MESH)
    counts = {f"run{ri}": c for ri, (_, c) in enumerate(model.runs)}
    if tcfg.encoder_layers:
        counts["encoder"] = tcfg.encoder_layers
    shapes = jax.eval_shape(JLM(jcfg).init, jax.random.PRNGKey(0))
    seen = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = _names(path)
        ref = tuple(jsh.spec_for(names, leaf.shape, jcfg, MESH))
        run = names[0]
        stacked = run in counts and (counts[run] > 1 or run == "encoder")
        keys = ([f"{run}.{c}." + ".".join(names[1:]) for c in range(counts[run])]
                if run in counts else [".".join(names)])
        for key in keys:
            mine = tuple(port[key])
            want = ref[1:] if stacked and ref else ref
            assert mine == want, (key, mine, ref)
            seen.add(key)
    assert seen == set(port)

    jcache = jax.eval_shape(lambda: JLM(jcfg).init_cache(2, 64))
    tcache = model.init_cache(2, 64, device="meta")
    ref = {_names(p): tuple(jsh.cache_spec_for(_names(p), leaf.shape, jcfg, MESH))
           for p, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]}
    assert dict(spec_leaves(sh.cache_specs(tcache, tcfg, MESH))) == ref


def spec_leaves(tree, path=()):
    """(path of str keys, spec) for every Spec of a nested dict/list."""
    if isinstance(tree, sh.Spec):
        yield path, tuple(tree)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from spec_leaves(v, path + (str(k),))
    else:
        for i, v in enumerate(tree):
            yield from spec_leaves(v, path + (str(i),))


def test_written_sharding_assertions():
    """``tests/test_sharding_spec.py``'s assertions on ``spec_for`` and
    ``batch_spec``, on the port."""
    tp = configs.get("gemma3-4b").replace(n_kv_heads=4, sharding_profile="tp")
    kv_bad = tp.replace(n_kv_heads=3)
    dp = tp.replace(sharding_profile="dp")

    def spec(names, shape, cfg):
        return as_list(sh.spec_for(names, shape, cfg, MESH))

    assert spec(("layers", "attn", "wk"), (512, 4, 128), tp) == ["data", "model", None]
    assert spec(("layers", "attn", "wk"), (512, 3, 128), kv_bad) == ["data", None, None]
    assert spec(("layers", "ffn", "w_up"), (512, 2048), tp) == ["data", "model"]
    assert spec(("layers", "ffn", "w_up"), (512, 99), tp) == ["data", None]
    assert spec(("layers", "ffn", "w_up"), (510, 2048), tp) == [None, "model"]
    assert spec(("layers", "ffn", "w_up"), (512, 2048), dp) == ["data", None]
    assert spec(("embed",), (32000, 512), dp) == [None, None]
    assert spec(("embed",), (32000, 512), tp) == ["model", None]
    assert spec(("layers", "attn", "wq"), (8, 512, 8, 64), tp) == [None, "data", "model", None]
    assert spec(("whatever", "mystery_w"), (16, 16), tp) == []
    assert as_list(sh.batch_spec(MESH, 3, batch=8)) == [["data"], None, None]
    assert as_list(sh.batch_spec(MESH, 3, batch=1)) == [None, None, None]
    assert as_list(sh.batch_spec(MESH, 3, batch=8, cfg=dp)) == [["data", "model"], None, None]
    assert batch_axes(MESH) == ("data",)
    for batch in (1, 2, 4, 8, 12):
        for cfg in (None, dp):
            jc = None if cfg is None else jconfigs.get("gemma3-4b").replace(
                sharding_profile="dp")
            assert bare(sh.batch_spec(MESH, 2, batch=batch, cfg=cfg)) == \
                bare(jsh.batch_spec(MESH, 2, batch=batch, cfg=jc))


def bare(spec) -> tuple:
    """A spec with one-name tuples as the bare name (jax 0.9's
    ``PartitionSpec`` stores them so)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in spec)


def test_resolve_comms_reasons():
    assert coll.resolve_comms("stream", rows=64, cols=512, bs=BS, bc=BC) == (None, None)
    with comm_context("model", 1):
        assert coll.resolve_comms("stream", rows=64, cols=512, bs=BS, bc=BC) == \
            ("dense", "single-device")
    with comm_context("model", 4):
        assert coll.resolve_comms("stream", rows=64, cols=512, bs=BS, bc=BC) == \
            ("compressed", None)
        assert coll.resolve_comms("fused", rows=64, cols=512, bs=BS, bc=BC) == \
            ("compressed", None)
        for backend in ("reference", "pallas"):
            assert coll.resolve_comms(backend, rows=64, cols=512, bs=BS, bc=BC) == \
                ("dense", "comms-capability")
        assert coll.resolve_comms("stream", rows=63, cols=512, bs=BS, bc=BC) == \
            ("dense", "non-divisible")
        board = BreakerBoard(BreakerConfig(trip_after=1))
        board.record_failure(coll.RING_SITE)
        with breaker_scope(board):
            assert coll.resolve_comms("stream", rows=64, cols=512, bs=BS, bc=BC) == \
                ("dense", "breaker-open")
    assert coll.RING_SITE == jcoll.RING_SITE


def test_exchanges_without_a_context_are_noops():
    cfg = configs.reduced("gemma3-4b").replace(zebra_backend="stream",
                                               zebra_sites=("ffn_hidden", "layer_out"))
    y = torch.randn(2, 16, 128)
    out, aux = ffn_layer_out_exchange(y, cfg, "infer")
    assert out is y and aux is None
    k, v = torch.randn(2, 16, 2, 320), torch.randn(2, 16, 2, 320)
    kk, vv, auxes = gather_kv_shards(k, v, ZebraConfig(backend="stream"))
    assert kk is k and vv is v and auxes == []


def test_single_device_axis_degrades_to_the_masked_map():
    """A size-1 axis (a bare declaration) moves nothing: the output is the
    masked shard, the label carries the reason, the link 0 bytes."""
    cfg = configs.reduced("gemma3-4b").replace(zebra_backend="stream", zebra_t_obj=3.5,
                                               zebra_sites=("ffn_hidden", "layer_out"),
                                               zebra_tnet=False)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 32, 128))
                         .astype(np.float32))
    with comm_context("model", 1):
        out, aux = ffn_layer_out_exchange(y, cfg, "infer")
    from repro_torch.core.engine import zebra_site
    from repro_torch.models.lm.ffn import zebra_cfg_for
    want, site = zebra_site(y, zebra_cfg_for(cfg, "infer").replace(use_tnet=False),
                            site="layer_out")
    assert np.array_equal(bits(out), bits(want))
    assert aux.backend == "stream+dense-comms(single-device)"
    assert int(aux.ici_bytes) == 0 and int(aux.ici_dense_bytes) == 0
    assert int(aux.measured_bytes) == int(site.measured_bytes) > 0


def test_attach_link_and_degrade_label():
    for mod, S, link in ((coll, SiteAux, lambda m, d: coll.LinkBytes(
            torch.tensor(m), torch.tensor(d))),
            (jcoll, JSiteAux, lambda m, d: jcoll.LinkBytes(jnp.int32(m), jnp.int32(d)))):
        sa = mod.attach_link(S.empty(backend="stream"), link(100, 400))
        assert (int(sa.ici_bytes), int(sa.ici_dense_bytes), sa.backend) == \
            (100, 400, "stream")
        sa = mod.attach_link(sa, mod.dense_link(50, 3), reason="non-divisible")
        assert (int(sa.ici_bytes), int(sa.ici_dense_bytes), sa.backend) == \
            (200, 500, "stream+dense-comms(non-divisible)")


def test_merge_site_aux_matches_reference():
    """The ici legs sum; the zero fraction is the block-weighted mean, as
    the jitted reference computes it."""
    rng = np.random.default_rng(0)
    for _ in range(40):
        za, zb = rng.random(2).astype(np.float32)
        na, nb = (int(v) for v in rng.integers(1, 5000, 2))
        a = coll.attach_link(SiteAux(zero_frac=torch.tensor(za), n_blocks=na,
                                     measured_bytes=torch.tensor(7, dtype=torch.int64),
                                     backend="stream"),
                             coll.LinkBytes(torch.tensor(10), torch.tensor(40)))
        b = coll.attach_link(SiteAux(zero_frac=torch.tensor(zb), n_blocks=nb,
                                     measured_bytes=torch.tensor(5, dtype=torch.int64),
                                     backend="stream"),
                             coll.LinkBytes(torch.tensor(5), torch.tensor(60)))
        m = merge_site_aux(a, b)

        def ref(za, zb):
            ja = JSiteAux(zero_frac=za, n_blocks=na, measured_bytes=jnp.int32(7),
                          backend="stream", ici_bytes=jnp.int32(10),
                          ici_dense_bytes=jnp.int32(40))
            jb = JSiteAux(zero_frac=zb, n_blocks=nb, measured_bytes=jnp.int32(5),
                          backend="stream", ici_bytes=jnp.int32(5),
                          ici_dense_bytes=jnp.int32(60))
            j = jmerge(ja, jb)
            return j.zero_frac, j.measured_bytes, j.ici_bytes, j.ici_dense_bytes
        jzf, jmb, jici, jicid = jax.jit(ref)(jnp.float32(za), jnp.float32(zb))
        assert (int(m.ici_bytes), int(m.ici_dense_bytes), int(m.measured_bytes)) == \
            (int(jici), int(jicid), int(jmb)) == (15, 100, 12)
        assert np.array_equal(bits(m.zero_frac), bits(jzf)), (za, zb, na, nb)
        assert m.n_blocks == na + nb and m.backend == "stream+stream"


def test_layer_aux_ici_past_16_mib():
    """Three layers of 7 MiB a link cross 2**24: the reference's pair and
    the port's int64 give the same exact totals."""
    per = 7 * 2 ** 20 + 1
    sa = coll.attach_link(SiteAux.empty("stream"),
                          coll.LinkBytes(torch.tensor(per), torch.tensor(4 * per)))
    jsa = jcoll.attach_link(JSiteAux.empty("stream"),
                            jcoll.LinkBytes(jnp.int32(per), jnp.int32(4 * per)))
    acc, jacc = LayerAux.zero(), JLayerAux.zero()
    for _ in range(3):
        acc, jacc = acc + LayerAux.of_site(sa), jacc + JLayerAux.of_site(jsa)
    assert acc.ici_bytes_exact() == jacc.ici_bytes_exact() == (3 * per, 12 * per)
    assert acc.ici_bytes_exact()[0] > 2 ** 24
    assert acc.ici_bytes.dtype == torch.int64
    # a site without a link adds no tensor
    plain = LayerAux.zero() + LayerAux.of_site(SiteAux.empty())
    assert plain.ici_bytes_exact() == (0, 0) and isinstance(plain.ici_bytes, int)


def test_meter_link_records_match_reference():
    kw = dict(m=256, k=1024, bs=BS, bc=BC, dtype_bits=32, n_live=300, n_maps=3)
    mine, ref = BandwidthMeter(), JMeter()
    r, jr = mine.record_link("layer_out", "model", **kw), ref.record_link(
        "layer_out", "model", **kw)
    for f in ("measured_bytes", "dense_bytes", "payload_bytes", "index_bytes", "n_blocks",
              "zero_frac", "predicted_bytes"):
        assert getattr(r, f) == getattr(jr, f), f
    mine.record_link("kv_cache", "data", m=64, k=640, bs=BS, bc=BC, dtype_bits=16,
                     n_live=17, n_maps=1)
    ref.record_link("kv_cache", "data", m=64, k=640, bs=BS, bc=BC, dtype_bits=16,
                    n_live=17, n_maps=1)
    assert mine.reconcile()["deltas"] == ref.reconcile()["deltas"]
    assert mine.ici_per_axis() == ref.ici_per_axis()
    assert mine.ici_bytes("model") == ref.ici_bytes("model") == r.measured_bytes
    assert mine.ici_dense_bytes() == ref.ici_dense_bytes()
    assert "LINKS model" in mine.report()
    r.payload_bytes += 4096          # off-model bytes break the bound
    with pytest.raises(AssertionError, match="index-padding bound"):
        mine.reconcile()


def test_ring_hop_tap_zeroes_its_hop_once():
    p = torch.ones(4, 8, 128)
    assert ring_hop_tap(p, 2, site="ring:x") is p
    with inject(Fault("drop_hop", site="ring:x", arg=2)) as plan:
        assert ring_hop_tap(p, 1, site="ring:x") is p
        assert ring_hop_tap(p, 2, site="ring:y") is p
        assert not ring_hop_tap(p, 2, site="ring:x").any()
        assert ring_hop_tap(p, 2, site="ring:x") is p
    assert plan.injected == [("drop_hop", "ring:x")]
