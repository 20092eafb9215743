"""The port's site engine against the reference's: ``zebra_site`` on the
reference, pallas and stream backends, NCHW and token layouts, must give
the same map bit for bit and the same ``SiteAux`` observables; ``LayerAux``
must sum bytes to the same exact integer."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ZebraConfig as JZebraConfig
from repro.core import backends as jbackends
from repro.core.engine import LayerAux as JLayerAux
from repro.core.engine import SiteAux as JSiteAux
from repro.core.engine import zebra_site as jax_site
from repro_torch.core import ZebraConfig, backends
from repro_torch.core.engine import LayerAux, SiteAux, nchw_stream_dims, zebra_site

from _torch_parity import bits

MAPS = {
    # name: (shape, layout, extra config)
    "nchw-b4": ((2, 3, 8, 8), "nchw", {"block_hw": 4}),
    "nchw-shrink-b3": ((2, 2, 6, 6), "nchw", {"block_hw": 4}),
    "nchw-b8": ((2, 4, 16, 16), "nchw", {"block_hw": 8}),
    "tokens-8x128": ((2, 16, 256), "tokens", {}),
    "tokens-2d": ((16, 256), "tokens", {}),
    "tokens-degenerate": ((2, 3, 256), "tokens", {}),
}


def make_map(shape, seed=0):
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.0, 2.0, size=shape[:-1] + (1,))
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("backend", ["stream", "pallas", "reference"])
@pytest.mark.parametrize("name", list(MAPS))
def test_zebra_site_matches_reference(name, backend):
    shape, layout, extra = MAPS[name]
    x = make_map(shape)
    if layout == "nchw":
        x = np.maximum(x, 0.0)                       # post-ReLU CNN map
    kw = dict(mode="infer", backend=backend, t_obj=1.0, **extra)
    y, aux = zebra_site(torch.from_numpy(x), ZebraConfig(**kw), site="s",
                        layout=layout)
    jy, jaux = jax_site(jnp.asarray(x), JZebraConfig(interpret=True, **kw),
                        site="s", layout=layout)
    np.testing.assert_array_equal(bits(y), bits(jy))
    # zero_frac as the reference's compiled programs (its trainer, its
    # server) report it: XLA rounds ``1 - mean(keep)`` once, a fused
    # multiply-add, where op by op it rounds twice; the two differ when the
    # block count is not a power of two (nchw-b4: 24 blocks)
    jzf = jax.jit(lambda xx: jax_site(xx, JZebraConfig(interpret=True, **kw), site="s",
                                      layout=layout)[1].zero_frac)(jnp.asarray(x))
    assert float(aux.zero_frac) == float(jzf)
    assert int(aux.measured_bytes) == int(jaux.measured_bytes)
    assert aux.n_blocks == jaux.n_blocks
    assert aux.backend == jaux.backend
    if name == "tokens-degenerate" and backend != "reference":
        assert aux.backend == "reference(degenerate-rows)"


def test_stream_equals_reference_map():
    x = torch.from_numpy(np.maximum(make_map((2, 4, 16, 16), 3), 0.0))
    cfg = ZebraConfig(mode="infer", t_obj=1.0, block_hw=8)
    ys, auxs = zebra_site(x, cfg.replace(backend="stream"), layout="nchw")
    yr, auxr = zebra_site(x, cfg, layout="nchw")
    assert torch.equal(ys, yr) and float(auxs.zero_frac) == float(auxr.zero_frac)
    assert int(auxs.measured_bytes) > 0 and int(auxr.measured_bytes) == 0


def test_layer_aux_exact_bytes_past_2_24():
    per_site = [16777215, 16777215, 5, 2 ** 24 + 3, 123456789]
    zf = [0.25, 0.5, 0.0, 1.0, 0.75]
    nb = [64, 32, 16, 8, 4]
    acc, jacc = LayerAux.zero(), JLayerAux.zero()
    for b, z, n in zip(per_site, zf, nb):
        acc = acc + LayerAux.of_site(SiteAux(
            reg=0.0, zero_frac=torch.tensor(z), n_blocks=n,
            measured_bytes=torch.tensor(b, dtype=torch.int64)))
        jacc = jacc + JLayerAux.of_site(JSiteAux(
            reg=jnp.float32(0), zero_frac=jnp.float32(z), n_blocks=n,
            measured_bytes=jnp.int32(b)))
    assert acc.measured_bytes_exact() == jacc.measured_bytes_exact() == sum(per_site)
    assert float(acc.zero_frac) == float(jacc.zero_frac)


def test_registry_matches_reference():
    assert backends.backend_names() == jbackends.backend_names()
    for name in backends.backend_names():
        assert (dataclasses.asdict(backends.backend_spec(name))
                == dataclasses.asdict(jbackends.backend_spec(name)))


def test_nchw_stream_dims():
    assert nchw_stream_dims((128, 64, 64, 64), 8) == (524288, 64, 8)
    assert nchw_stream_dims((2, 3, 6, 6), 4) == (36, 6, 3)
    assert nchw_stream_dims((2, 3), 4) is None


@pytest.mark.parametrize("case", ["fused", "validation", "typo"])
def test_unported_paths_raise(case):
    """Names outside the reference's sets raise; every validation level
    and the fused path (validated or not) run."""
    x = torch.ones(1, 1, 8, 8)
    if case == "validation":
        with pytest.raises(ValueError, match="validation level"):
            ZebraConfig(validation="crc")
        for level in ("off", "structural", "checksum"):
            assert ZebraConfig(validation=level).validation == level
        return
    if case == "typo":
        with pytest.raises(ValueError):
            ZebraConfig(backend="steam")
        return
    y, aux = zebra_site(x, ZebraConfig(mode="infer", backend=case), layout="nchw")
    assert aux.backend == "fused" and torch.equal(y, x)
    y, aux = zebra_site(x, ZebraConfig(mode="infer", backend=case, validation="structural"),
                        layout="nchw")
    assert aux.backend == "fused" and torch.equal(y, x) and int(aux.measured_bytes) > 0


@pytest.mark.parametrize("backend", ["pallas", "stream"])
def test_train_mode_site_equals_reference(backend):
    """A constant-threshold train-mode site on a kernel backend: the same
    map, gradient and observables as the reference backend's."""
    x = np.maximum(make_map((2, 4, 16, 16), 5), 0.0)
    cfg = ZebraConfig(mode="train", use_tnet=False, t_obj=3.0, block_hw=8)
    out = {}
    for name in ("reference", backend):
        xt = torch.from_numpy(x).requires_grad_(True)
        y, aux = zebra_site(xt, cfg.replace(backend=name), layout="nchw")
        (y * torch.arange(y.numel()).reshape(y.shape)).sum().backward()
        out[name] = (y.detach(), xt.grad, aux)
    (yr, gr, ar), (yk, gk, ak) = out["reference"], out[backend]
    assert torch.equal(yr, yk) and torch.equal(gr, gk)
    assert 0.0 < float(ak.zero_frac) < 1.0 and ak.backend == backend
    assert float(ak.zero_frac) == float(ar.zero_frac) and float(ak.reg) == float(ar.reg)
    assert (int(ak.measured_bytes) > 0) == (backend == "stream")


def test_pallas_infer_site_equals_reference():
    x = torch.from_numpy(make_map((2, 16, 256), 6))        # signed token map
    cfg = ZebraConfig(mode="infer", t_obj=5.0)
    yp, auxp = zebra_site(x, cfg.replace(backend="pallas"))
    yr, auxr = zebra_site(x, cfg)
    assert torch.equal(yp.view(torch.int32), yr.view(torch.int32))     # -0.0 too
    assert float(auxp.zero_frac) == float(auxr.zero_frac)
    assert 0.0 < float(auxp.zero_frac) < 1.0 and auxp.backend == "pallas"
    assert int(auxp.measured_bytes) == 0


@pytest.mark.parametrize("mode,t_obj", [("train", 0.0), ("train", 0.5), ("infer", 0.0),
                                        ("infer", 0.5)])
def test_stream_site_with_a_nan_block_counts_the_stream_it_moved(mode, t_obj):
    """One NaN in a (1, 16, 256) float32 map of 8x128 blocks: its block is
    dead (a NaN max compares false), so the stream holds 3 of 4 blocks,
    12289 bytes. The port reports that stream in both modes. The
    reference's train branch recomputes keep from the expanded output,
    where the dropped block came back as +0, and at T_obj 0 counts it
    live: 0.0 and 16385 bytes, against its own infer branch's 0.25 and
    12289. Both figures are pinned here."""
    x = make_map((1, 16, 256), 11)
    x[0, 3, 5] = np.nan
    kw = dict(mode=mode, backend="stream", t_obj=t_obj, use_tnet=False)
    _, aux = zebra_site(torch.from_numpy(x), ZebraConfig(**kw), site="s")
    _, jaux = jax_site(jnp.asarray(x), JZebraConfig(interpret=True, **kw), site="s")
    assert (float(aux.zero_frac), int(aux.measured_bytes)) == (0.25, 12289)
    want_ref = (0.0, 16385) if (mode, t_obj) == ("train", 0.0) else (0.25, 12289)
    assert (float(jaux.zero_frac), int(jaux.measured_bytes)) == want_ref
