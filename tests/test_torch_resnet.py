"""ResNet-18 in the port against the reference, with the reference's
initial variables carried across by ``from_jax_variables``: logits,
per-site bitmaps and stream bytes, and ``CNNTrainer.evaluate``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.cnn.common as jcommon
import repro_torch.models.cnn.common as tcommon
from repro.core import ZebraConfig as JZebraConfig
from repro.data import SYN_TINYIMAGENET as J_TINY
from repro.models.cnn import resnet18 as jax_resnet18
from repro.models.layers import conv_apply as jax_conv
from repro.optim import sgd, step_decay
from repro.train.cnn_trainer import CNNTrainConfig as JTrainConfig
from repro.train.cnn_trainer import CNNTrainer as JTrainer
from repro_torch.core import ZebraConfig
from repro_torch.data import SYN_TINYIMAGENET, image_batch
from repro_torch.models.cnn import resnet18
from repro_torch.models.cnn.convert import from_jax_variables
from repro_torch.models.layers import conv_apply
from repro_torch.train import CNNTrainConfig, CNNTrainer

T_OBJ = 1.5
ZKW = dict(mode="infer", backend="stream", block_hw=8, t_obj=T_OBJ)


@pytest.fixture(scope="module")
def jax_model():
    model = jax_resnet18(200, 64, width_mult=0.125)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0))
    return model, variables, jax.tree_util.tree_map(np.asarray, variables)


def _recording(monkeypatch, module, log):
    inner = module.zebra_site

    def site(x, cfg, **kw):
        y, aux = inner(x, cfg, **kw)
        log.append((x, cfg.block_hw, aux.measured_bytes, aux.zero_frac))
        return y, aux
    monkeypatch.setattr(module, "zebra_site", site)


def _jax_forward(jmodel, jvars, images, monkeypatch):
    """The reference's jitted forward, returning each site's input map and
    stream bytes as outputs of the same program."""
    blocks = []        # static, filled while tracing

    def run(variables, x):
        log = []
        _recording(monkeypatch, jcommon, log)
        logits, _, _ = jmodel.apply(variables, x, False,
                                    JZebraConfig(interpret=True, **ZKW))
        blocks[:] = [b for _, b, _, _ in log]
        return logits, [(m, mb, zf) for m, _, mb, zf in log]
    logits, sites = jax.jit(run)(jvars, jnp.asarray(images))
    return np.asarray(logits), [(np.asarray(m), b, mb, zf)
                                for (m, mb, zf), b in zip(sites, blocks)]


def _blockmax(x, b):
    B, C, H, W = x.shape
    return np.abs(x.reshape(B, C, H // b, b, W // b, b)).max(axis=(3, 5))


def test_logits_bitmaps_and_bytes_match(jax_model, monkeypatch):
    jmodel, jvars, vars_np = jax_model
    images, _ = image_batch(SYN_TINYIMAGENET, 2, 10_000)
    jlogits, jlog = _jax_forward(jmodel, jvars, images, monkeypatch)
    tlog = []
    _recording(monkeypatch, tcommon, tlog)
    model = from_jax_variables(resnet18(200, 64, width_mult=0.125), vars_np).eval()
    with torch.inference_mode():
        logits, _, auxes = model(torch.from_numpy(images), ZebraConfig(**ZKW))
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=1e-4, atol=1e-4)
    assert len(jlog) == len(tlog) == 17
    t_f32 = np.float32(T_OBJ)
    for i, ((jx, jb, jbytes, jzf), (tx, tb, tbytes, tzf)) in enumerate(zip(jlog, tlog)):
        tx = tx.numpy()
        assert jb == tb == 8
        jmax = _blockmax(jx, jb)
        jkeep, tkeep = jmax >= t_f32, _blockmax(tx, tb) >= t_f32
        differ = jkeep != tkeep
        assert (np.abs(jmax[differ] - T_OBJ) < 1e-4).all(), f"site z{i}"
        if not differ.any():
            assert int(tbytes) == int(jbytes), f"site z{i}"
            assert float(tzf) == float(jzf), f"site z{i}"


def test_evaluate_matches_reference(jax_model):
    _, jvars, vars_np = jax_model
    jtr = JTrainer(JTrainConfig(model="resnet18", width_mult=0.125, dataset=J_TINY,
                                zebra=JZebraConfig(interpret=True, **ZKW)),
                   sgd(step_decay(0.05, total_steps=1)))
    jout = jtr.evaluate(jvars, batches=1, batch=2)
    tr = CNNTrainer(CNNTrainConfig(model="resnet18", width_mult=0.125,
                                   dataset=SYN_TINYIMAGENET, zebra=ZebraConfig(**ZKW)),
                    device="cpu")
    variables = from_jax_variables(tr.model, vars_np).state_dict()
    out = tr.evaluate(variables, batches=1, batch=2)
    assert out["acc"] == jout["acc"] and out["top5"] == jout["top5"]
    assert out["measured_bytes"] == jout["measured_bytes"]
    assert isinstance(out["measured_bytes"], int)
    np.testing.assert_array_equal(out["site_zero_fracs"], jout["site_zero_fracs"])
    assert out["zero_frac"] == pytest.approx(jout["zero_frac"], rel=1e-6)
    assert out["reduced_bandwidth_pct"] == pytest.approx(jout["reduced_bandwidth_pct"],
                                                         rel=1e-6)


@pytest.mark.parametrize("k,stride,hw", [(3, 2, 16), (1, 2, 16), (3, 1, 16), (3, 2, 15)])
def test_conv_same_padding(k, stride, hw):
    """XLA's SAME pads the odd pixel after the map: a stride-2 3x3 conv on
    an even map pads (0, 1); symmetric padding=1 would differ."""
    rng = np.random.default_rng(k * 100 + stride * 10 + hw)
    x = rng.normal(size=(2, 3, hw, hw)).astype(np.float32)
    w = rng.normal(size=(4, 3, k, k)).astype(np.float32)
    y = conv_apply(torch.from_numpy(w), torch.from_numpy(x), stride)
    jy = np.asarray(jax_conv({"w": jnp.asarray(w)}, jnp.asarray(x), stride=stride))
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-5, atol=1e-5)
    if (k, stride, hw) == (3, 2, 16):
        sym = torch.nn.functional.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                         stride=2, padding=1)
        assert np.abs(sym.numpy() - jy).max() > 1e-2


def test_from_jax_variables_rejects_mismatched_trees(jax_model):
    _, _, vars_np = jax_model
    with pytest.raises(ValueError):
        from_jax_variables(resnet18(200, 64, width_mult=0.25), vars_np)
    with pytest.raises(ValueError):
        from_jax_variables(resnet18(200, 64, width_mult=0.125, use_tnet=False), vars_np)


def test_map_specs_match_reference(jax_model):
    jmodel, _, _ = jax_model
    for zkw in ({"block_hw": 8}, {"block_hw": 4, "act_bits": 32}):
        assert ([vars(s) for s in resnet18(200, 64, width_mult=0.125).map_specs(
                    64, ZebraConfig(**zkw))]
                == [vars(s) for s in jmodel.map_specs(64, JZebraConfig(**zkw))])
