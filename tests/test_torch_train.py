"""Training in the port against the reference, on the same numpy inputs:
the trainable kernel Function, train-mode Zebra sites with threshold nets,
BatchNorm in train mode, the optimizers and schedules, the partner
methods, and whole ``CNNTrainer`` steps, including a trainer state carried
across from the reference.

Tolerances: the kernel backends' trainable sites are bitwise (the same
float32 operations on both sides). Everything that sums in another order
(threshold nets, BatchNorm statistics, convolutions, optimizer updates) is
allclose at rtol 1e-5 with an absolute floor of 1e-5, except the parameters
after two optimizer steps (atol 1e-4: two updates of a clipped gradient at
lr 0.05). ``zero_frac`` and ``measured_bytes`` of a trainer step are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ZebraConfig as JZebraConfig
from repro.core import slimming as jslim
from repro.core import weight_pruning as jwp
from repro.core import zebra as jzebra
from repro.core import zebra_site as jax_site
from repro.data import ImageDatasetConfig as JDataset
from repro.data import image_batch as jax_image_batch
from repro.models.layers import bn_apply as jax_bn
from repro import optim as joptim
from repro.train import CNNTrainConfig as JTrainConfig
from repro.train import CNNTrainer as JTrainer
from repro_torch import optim
from repro_torch.core import ThresholdNet, ZebraConfig, slimming, weight_pruning, zebra_site
from repro_torch.core.zebra import zebra_cnn, zebra_tokens
from repro_torch.data import ImageDatasetConfig
from repro_torch.kernels import grad
from repro_torch.models.cnn.convert import from_jax_state
from repro_torch.models.layers import bn_apply
from repro_torch.train import CNNTrainConfig, CNNTrainer
from repro_torch.utils import quantile

from _torch_parity import bits, jax_cnn_variables

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_MODES = ("hard", "ste", "soft")


def _close(a, b, **tol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), **(tol or TOL))


def _blocky(shape, layout, seed):
    """A map whose blocks differ in scale; NCHW maps are post-ReLU, with
    all-zero blocks and a block whose max is tied."""
    rng = np.random.default_rng(seed)
    if layout == "nchw":
        x = rng.normal(size=shape) * rng.uniform(0.0, 1.5, size=shape[:-1] + (1,))
    else:                                      # one scale per 8x128 block
        B, S, D = shape
        x = (rng.normal(size=(B, S // 8, 8, D // 128, 128))
             * rng.uniform(0.0, 1.5, size=(B, S // 8, 1, D // 128, 1))).reshape(shape)
    if layout == "nchw":
        x = np.maximum(x, 0.0)
        x[0, 0, :4, :4] = 0.0                  # a dead, all-tied block
        x[0, 1, :4, :4] = 0.0
        x[0, 1, 0, 0] = x[0, 1, 3, 3] = 0.9    # two tied maxima
    return x.astype(np.float32)


MAPS = {"nchw": ((2, 4, 8, 8), {"block_hw": 4}),
        "tokens": ((2, 16, 256), {})}


# ---------------------------------------------------------------------------
# The trainable kernel Function against jax.grad through zebra_kernel_trainable
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(MAPS))
@pytest.mark.parametrize("backend", ["pallas", "stream"])
@pytest.mark.parametrize("grad_mode", GRAD_MODES)
def test_kernel_trainable_grad_is_bitwise(grad_mode, backend, layout):
    shape, extra = MAPS[layout]
    x = _blocky(shape, layout, seed=len(layout))
    kw = dict(mode="train", backend=backend, grad_mode=grad_mode, use_tnet=False,
              t_obj=0.5, **extra)

    def jloss(xx):
        y, aux = jax_site(xx, JZebraConfig(**kw), layout=layout)
        return jnp.sum(y ** 2), (y, aux)
    (_, (jy, jaux)), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = zebra_site(xt, ZebraConfig(**kw), layout=layout)
    (y ** 2).sum().backward()
    np.testing.assert_array_equal(bits(y), bits(jy))
    np.testing.assert_array_equal(bits(xt.grad), bits(jg))
    assert aux.backend == jaux.backend == backend
    assert float(aux.zero_frac) == float(jaux.zero_frac)
    assert float(aux.reg) == float(jaux.reg)          # realised zero-block count
    assert int(aux.measured_bytes) == int(jaux.measured_bytes)
    assert (int(aux.measured_bytes) > 0) == (backend == "stream")


def test_kernel_trainable_observables_carry_no_gradient():
    x = torch.from_numpy(_blocky((2, 4, 8, 8), "nchw", 0)).requires_grad_(True)
    s = grad.KernelStatics("mask", 0.5, 4, 4, "hard", 0.05)
    y2, bitmap, n_live = grad.zebra_kernel_trainable(x.reshape(64, 8), s)
    assert y2.requires_grad and not bitmap.requires_grad and not n_live.requires_grad
    with pytest.raises(ValueError, match="variant"):
        grad.launch_forward(x.reshape(64, 8), s._replace(variant="fused"))


# ---------------------------------------------------------------------------
# Train-mode sites with a threshold net (the reference backend, Eq. 1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(MAPS))
@pytest.mark.parametrize("grad_mode", GRAD_MODES)
def test_tnet_site_matches_reference(grad_mode, layout):
    shape, extra = MAPS[layout]
    x = _blocky(shape, layout, seed=7)
    rng = np.random.default_rng(8)
    d_in = shape[1] if layout == "nchw" else shape[-1]
    d_out = shape[1] if layout == "nchw" else shape[-1] // 128
    w = (rng.normal(size=(d_in, d_out)) * d_in ** -0.5).astype(np.float32)
    # thresholds around the median block max, so some blocks die
    b = (rng.normal(size=(d_out,)) * 0.1 + (0.5 if layout == "nchw" else 2.0)
         ).astype(np.float32)
    kw = dict(mode="train", grad_mode=grad_mode, t_obj=0.4, **extra)
    jfn, tfn = ((jzebra.zebra_cnn, zebra_cnn) if layout == "nchw"
                else (jzebra.zebra_tokens, zebra_tokens))

    def jloss(xx, tnet):
        y, aux = jfn(xx, JZebraConfig(**kw), tnet)
        return jnp.sum(y ** 2) + aux["reg"], (y, aux)
    (_, (jy, jaux)), (jgx, jgnet) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {"w": jnp.asarray(w), "b": jnp.asarray(b)})

    net = ThresholdNet(d_in, d_out)
    with torch.no_grad():
        net.w.copy_(torch.from_numpy(w))
        net.b.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tfn(xt, ZebraConfig(**kw), net)
    ((y ** 2).sum() + aux["reg"]).backward()
    _close(y, jy)
    _close(aux["reg"], jaux["reg"])
    _close(aux["thresholds"], jaux["thresholds"])
    assert float(aux["zero_frac"]) == float(jaux["zero_frac"])
    assert 0.0 < float(aux["zero_frac"]) < 1.0
    _close(xt.grad, jgx)
    _close(net.w.grad, jgnet["w"])
    _close(net.b.grad, jgnet["b"])


def test_train_mode_requires_a_net_unless_constant_threshold():
    x = torch.ones(1, 2, 4, 4)
    with pytest.raises(ValueError, match="threshold net"):
        zebra_cnn(x, ZebraConfig(mode="train", block_hw=4))
    with pytest.raises(ValueError, match="threshold net at site 'z3'"):
        zebra_site(x, ZebraConfig(mode="train", block_hw=4, backend="stream"),
                   site="z3", layout="nchw")
    _, aux = zebra_site(x, ZebraConfig(mode="train", block_hw=4, backend="stream"),
                        layout="nchw", tnet=ThresholdNet(2))
    assert aux.backend == "reference(tnet)"


# ---------------------------------------------------------------------------
# BatchNorm in train mode
# ---------------------------------------------------------------------------

def test_batchnorm_train_mode_matches_reference():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 3, 5, 5)) * 2 + 1).astype(np.float32)
    scale, bias = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    mean, var = rng.normal(size=3).astype(np.float32), rng.uniform(0.5, 2, 3).astype(np.float32)
    jy, js = jax_bn({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                    {"mean": jnp.asarray(mean), "var": jnp.asarray(var)},
                    jnp.asarray(x), True)
    t = [torch.from_numpy(a) for a in (scale, bias, mean, var, x)]
    y, (new_mean, new_var) = bn_apply(*t, train=True)
    _close(y, jy)
    _close(new_mean, js["mean"])
    _close(new_var, js["var"])                    # biased batch variance
    assert new_mean.dtype == new_var.dtype == torch.float32
    y_eval, stats = bn_apply(*t, train=False)
    assert stats[0] is t[2] and stats[1] is t[3]  # running stats untouched


# ---------------------------------------------------------------------------
# Optimizers and schedules
# ---------------------------------------------------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(4, 3)).astype(np.float32)},
            "b": rng.normal(size=(5,)).astype(np.float32)}


def _flat(tree):
    return {"a.w": tree["a"]["w"], "b": tree["b"]}


@pytest.mark.parametrize("name", ["sgd", "sgd-nesterov", "adamw"])
def test_optimizer_matches_reference(name):
    jopt, topt = {
        "sgd": (joptim.sgd(joptim.step_decay(0.1, total_steps=4)),
                optim.sgd(optim.step_decay(0.1, total_steps=4))),
        "sgd-nesterov": (joptim.sgd(joptim.cosine(0.1, 4), nesterov=True),
                         optim.sgd(optim.cosine(0.1, 4), nesterov=True)),
        "adamw": (joptim.adamw(joptim.warmup_cosine(1e-2, 2, 5)),
                  optim.adamw(optim.warmup_cosine(1e-2, 2, 5))),
    }[name]
    jp = jax.tree_util.tree_map(jnp.asarray, _tree(0))
    tp = {k: torch.from_numpy(v) for k, v in _flat(_tree(0)).items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(4):
        g = _tree(10 + step)
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, jnp.int32(step))
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in _flat(g).items()},
                             ts, tp, step)
        jp, tp = joptim.apply_updates(jp, ju), optim.apply_updates(tp, tu)
        for k, v in _flat(jax.tree_util.tree_map(np.asarray, jp)).items():
            _close(tp[k], v, rtol=1e-6, atol=1e-7)
        for slot in ts:
            for k, v in _flat(jax.tree_util.tree_map(np.asarray, js[slot])).items():
                _close(ts[slot][k], v, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(5)
    jg, jn = joptim.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g), max_norm)
    tg, tn = optim.clip_by_global_norm({k: torch.from_numpy(v) for k, v in _flat(g).items()},
                                       max_norm)
    _close(tn, jn, rtol=1e-6, atol=0)
    for k, v in _flat(jax.tree_util.tree_map(np.asarray, jg)).items():
        _close(tg[k], v, rtol=1e-6, atol=0)


def test_schedules_match_reference():
    pairs = [(joptim.constant(0.3), optim.constant(0.3)),
             (joptim.step_decay(0.1, total_steps=8), optim.step_decay(0.1, total_steps=8)),
             (joptim.cosine(0.1, 8, min_frac=0.1), optim.cosine(0.1, 8, min_frac=0.1)),
             (joptim.warmup_cosine(0.1, 3, 10), optim.warmup_cosine(0.1, 3, 10))]
    for jfn, tfn in pairs:
        for step in range(12):
            got = tfn(step)
            assert isinstance(got, float)
            np.testing.assert_allclose(got, float(jfn(jnp.int32(step))), rtol=1e-6)


# ---------------------------------------------------------------------------
# Partner methods
# ---------------------------------------------------------------------------

def _cnn_params(seed):
    rng = np.random.default_rng(seed)
    return {"bn_stem": {"scale": rng.normal(size=8).astype(np.float32),
                        "bias": rng.normal(size=8).astype(np.float32)},
            "s0b0": {"conv1": {"w": rng.normal(size=(8, 8, 3, 3)).astype(np.float32)},
                     "bn1": {"scale": rng.normal(size=8).astype(np.float32),
                             "bias": rng.normal(size=8).astype(np.float32)}},
            "fc": {"w": rng.normal(size=(8, 10)).astype(np.float32),
                   "b": rng.normal(size=10).astype(np.float32)}}


def _flat_cnn(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_cnn(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_slimming_matches_reference():
    p = _cnn_params(0)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = {k: torch.from_numpy(v) for k, v in _flat_cnn(p).items()}
    _close(slimming.gamma_l1(tp), jslim.gamma_l1(jp), rtol=1e-6, atol=0)
    jm, tm = jslim.channel_masks(jp, 0.4), slimming.channel_masks(tp, 0.4)
    assert sorted(tm) == sorted(".".join(k) for k in jm)
    for names, m in jm.items():
        np.testing.assert_array_equal(tm[".".join(names)].numpy(), np.asarray(m))
    assert slimming.pruned_channel_frac(tm) == pytest.approx(jslim.pruned_channel_frac(jm))
    got = slimming.apply_masks(tp, tm)
    for k, v in _flat_cnn(jax.tree_util.tree_map(np.asarray, jslim.apply_masks(jp, jm))).items():
        np.testing.assert_array_equal(got[k].numpy(), v)


@pytest.mark.parametrize("prune_frac", [0.5, 0.3])
def test_weight_pruning_matches_reference(prune_frac):
    p = _cnn_params(1)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = {k: torch.from_numpy(v) for k, v in _flat_cnn(p).items()}
    jm = jwp.magnitude_masks(jp, prune_frac)
    tm = weight_pruning.magnitude_masks(tp, prune_frac)
    want = {k: v for k, v in _flat_cnn(jax.tree_util.tree_map(
        lambda a: a, jm, is_leaf=lambda a: a is None)).items() if v is not None}
    assert sorted(tm) == sorted(want) == ["fc.w", "s0b0.conv1.w"]
    for k, v in want.items():
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(v))
    assert weight_pruning.sparsity(tm) == pytest.approx(jwp.sparsity(jm))
    got = weight_pruning.apply_masks(tp, tm)
    for k, v in _flat_cnn(jax.tree_util.tree_map(np.asarray, jwp.apply_masks(jp, jm))).items():
        np.testing.assert_array_equal(got[k].numpy(), v)


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1001])
def test_quantile_matches_jnp(n):
    """Bitwise against ``jnp.quantile`` at several sizes and quantiles, NaN
    included: the partner methods' cuts equal the reference's."""
    rng = np.random.default_rng(n)
    for trial in range(5):
        x = rng.standard_normal(n).astype(np.float32)
        if trial == 4:
            x[rng.integers(n)] = np.nan
        for q in (0.0, 0.1, 0.25, 0.37, 0.5, 0.9, 1.0):
            got = quantile(torch.from_numpy(x), q).numpy()
            want = np.asarray(jnp.quantile(jnp.asarray(x), q))
            assert got.view(np.int32) == want.view(np.int32), (trial, q, got, want)


def test_quantile_above_torch_limit():
    """More than 2**24 elements, where ``torch.quantile`` refuses (VGG-16's
    fc1 alone holds ~103M weights): the two order statistics come from
    ``np.partition`` and the interpolation is the float32 one of the
    helper's docstring, which the small cases above hold to ``jnp``."""
    n, q = 2 ** 24 + 3, 0.37
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    pos = np.float32(q) * (np.float32(n) - np.float32(1))
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    part = np.partition(x, (lo, hi))
    w = np.float32(pos - np.float32(lo))
    want = np.float32(np.float64(part[hi]) * np.float64(w)
                      + np.float64(part[lo] * (np.float32(1) - w)))
    assert quantile(torch.from_numpy(x), q).numpy() == want


# ---------------------------------------------------------------------------
# Whole trainer steps: ResNet-18 at width 0.125 on 8x8 images
# ---------------------------------------------------------------------------

RUNS = {
    # name: (backend, use_tnet, optimizer maker)
    "reference-tnet": ("reference", True, "sgd"),
    "pallas": ("pallas", False, "sgd"),
    "stream": ("stream", False, "adamw"),
}
DATA = dict(name="syn-cifar10", num_classes=10, hw=8, seed=3)


def _optimizers(kind):
    if kind == "sgd":
        return (joptim.sgd(joptim.step_decay(0.05, total_steps=4)),
                optim.sgd(optim.step_decay(0.05, total_steps=4)))
    return (joptim.adamw(joptim.warmup_cosine(1e-2, 1, 4)),
            optim.adamw(optim.warmup_cosine(1e-2, 1, 4)))


@pytest.fixture(scope="module")
def jax_runs():
    """The reference trainer's states after 0, 1 and 2 steps, and its
    metrics, per run (computed once per run)."""
    cache = {}

    def get(name):
        if name not in cache:
            backend, use_tnet, opt = RUNS[name]
            zkw = dict(t_obj=0.25, block_hw=4, backend=backend, use_tnet=use_tnet)
            cfg = JTrainConfig(model="resnet18", width_mult=0.125, dataset=JDataset(**DATA),
                               batch=8, steps=2, zebra=JZebraConfig(**zkw), seed=0)
            tr = JTrainer(cfg, _optimizers(opt)[0])
            # the trainer's init_state, from the port's random weights
            # (the reference's own init takes seconds to compile)
            variables = jax_cnn_variables(_port_trainer(name, zkw).model)
            state = {"variables": variables, "opt": tr.opt.init(tr._trainable(variables)),
                     "step": jnp.int32(0)}
            states, metrics = [state], []
            for i in range(2):
                images, labels = jax_image_batch(cfg.dataset, cfg.batch, i)
                state, m = tr._train_step(state, images, labels)
                states.append(state)
                metrics.append(m)
            to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
            cache[name] = ([to_np(s) for s in states], to_np(metrics), zkw)
        return cache[name]
    return get


def _port_trainer(name, zkw):
    cfg = CNNTrainConfig(model="resnet18", width_mult=0.125,
                         dataset=ImageDatasetConfig(**DATA), batch=8, steps=2,
                         zebra=ZebraConfig(**zkw), seed=0)
    return CNNTrainer(cfg, _optimizers(RUNS[name][2])[1], device="cpu")


def _assert_state_close(tr, state, jstate, atol):
    want = from_jax_state(tr.model, jstate)
    assert state["step"] == want["step"]
    for k, v in want["variables"].items():
        _close(state["variables"][k], v, rtol=1e-4, atol=atol)
    assert sorted(state["opt"]) == sorted(want["opt"])
    for slot in want["opt"]:
        for k, v in want["opt"][slot].items():
            _close(state["opt"][slot][k], v, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("name", list(RUNS))
def test_trainer_steps_match_reference(name, jax_runs):
    jstates, jmetrics, zkw = jax_runs(name)
    tr = _port_trainer(name, zkw)
    state = from_jax_state(tr.model, jstates[0])
    state, history = tr.train(steps=2, log_every=1, state=state)
    assert [m["step"] for m in history] == [1, 2]
    for m, jm in zip(history, jmetrics):
        for k in ("loss", "ce", "zebra_reg", "acc", "grad_norm"):
            np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-5, err_msg=k)
        assert m["zero_frac"] == float(jm["zero_frac"])
        assert m["measured_bytes"] == (int(jm["measured_bytes_hi"]) * 2 ** 24
                                       + int(jm["measured_bytes_lo"]))
        assert (m["measured_bytes"] > 0) == (zkw["backend"] == "stream")
    _assert_state_close(tr, state, jstates[2], atol=1e-4)


@pytest.mark.parametrize("name", ["reference-tnet", "stream"])
def test_trainer_state_carries_across(name, jax_runs):
    """A state the reference trained for one step (SGD momentum, or AdamW's
    m and v, nonzero) continues for one step in the port."""
    jstates, jmetrics, zkw = jax_runs(name)
    tr = _port_trainer(name, zkw)
    state = from_jax_state(tr.model, jstates[1])
    assert state["step"] == 1 and any(float(t.abs().sum()) > 0
                                      for t in next(iter(state["opt"].values())).values())
    images, labels = jax_image_batch(JDataset(**DATA), 8, 1)
    state, metrics = tr._step(state, torch.from_numpy(images), torch.from_numpy(labels))
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics[1]["loss"]), rtol=1e-5)
    _assert_state_close(tr, state, jstates[2], atol=1e-5)


def test_partner_masks_hold_through_a_step(jax_runs):
    jstates, _, zkw = jax_runs("pallas")
    tr = _port_trainer("pallas", zkw)
    state = from_jax_state(tr.model, jstates[2])      # BN scales no longer all 1
    assert 0.45 < tr.apply_weight_pruning(state["variables"], 0.5) < 0.55
    assert 0.25 < tr.apply_network_slimming(state["variables"], 0.3) < 0.35
    images, labels = jax_image_batch(JDataset(**DATA), 8, 0)
    state, _ = tr._step(state, torch.from_numpy(images), torch.from_numpy(labels))
    for k, m in tr.wp_masks.items():
        assert not state["variables"][k][m == 0].any(), k
    for k, m in tr.ns_masks.items():
        assert not state["variables"][k][m == 0].any(), k
    assert not any(k.startswith("zebra.") for k in tr.wp_masks)
