"""LM training in the port against the reference package: compressed
gradients, ``LM.loss`` with and without the chunked cross-entropy, whole
train steps on ``reference``, ``pallas`` and ``stream`` at a threshold
where blocks die, gradient accumulation, threshold-net training with the
``layer_out`` site, ``fused`` in train mode, and the in-place optimizers.

Inputs come from numpy seeds (``data.lm_batch``); the reference's
weights cross with ``models.lm.convert.from_jax_params``, and its steps
run under ``jax.jit``. Tolerances:

* compressed gradients, the in-place optimizers against the functional
  form, and the three port backends against each other: bitwise;
* ``zero_frac``, ``zebra_reg`` at a constant threshold (a block count)
  and the stream bytes: exact;
* float32 losses and grad norms: rtol 1e-5 (another order of summation);
  float32 gradients: atol 1e-6 (sums over the batch's tokens with
  cancellation; the largest difference seen is 3.2e-7);
* parameters after two AdamW steps at lr 1e-3: atol 1e-4. Adam's first
  update is ``g / (|g| + eps)``, which turns the rounding noise of a
  gradient near eps (1e-8) into a visible step (the largest difference
  seen is 3.7e-5);
* bf16 compute: silu rounds after each op as XLA does, but the bf16
  projections sum in another order and XLA skips the rounding of a bf16
  sum that a norm upcasts, so a few maps differ in the last bit
  (``test_torch_activations.py`` names the ops and the blocks). The
  reduced gemma3-4b's loss at rtol 1e-3 and its zero_frac one block of
  384 above the reference's (one net block on the other side of T_obj);
  the ``lm-2l-64d`` steps, where no block dies, at rtol 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro import optim as joptim
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_train_state_shape, make_train_step
from repro.models.lm import LM as JLM
from repro.models.lm import LMConfig as JLMConfig
from repro.models.lm.ffn import ffn_apply as jffn_apply
from repro.optim import compress as jcompress
from repro_torch import configs, optim
from repro_torch.data import LMDatasetConfig, lm_batch
from repro_torch.launch import steps
from repro_torch.models.lm import LM, LMConfig
from repro_torch.models.lm import model as model_mod
from repro_torch.models.lm.convert import from_jax_params, port_params
from repro_torch.models.lm.ffn import ffn_apply
from repro_torch.optim import compress

from _torch_parity import bits, jax_lm_params

B, S = 2, 128
T_OBJ = 2.45          # float32 ffn_hidden zero fraction 0.589 on these weights


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(vocab, batch=B, seq=S, step=0):
    return lm_batch(LMDatasetConfig(vocab=vocab), batch, seq, step)


def _cfgs(**kw):
    """The reduced gemma3-4b (6 layers: 5 local, 1 global; d 128, window 32,
    attn_chunk 64) in both packages."""
    return jconfigs.reduced("gemma3-4b").replace(**kw), configs.reduced("gemma3-4b").replace(**kw)


def _grads_close(model, grads, jgrads, atol=1e-6):
    want = port_params(model, _np(jgrads))
    assert set(want) == set(grads)
    for k, v in want.items():
        np.testing.assert_allclose(grads[k].numpy(), v, rtol=1e-4, atol=atol, err_msg=k)


def _params_close(model, jparams, atol):
    for k, v in port_params(model, _np(jparams)).items():
        np.testing.assert_allclose(model.state_dict()[k].numpy(), v, rtol=1e-4, atol=atol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# Compressed gradients
# ---------------------------------------------------------------------------

def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": (rng.normal(size=(33, 17)) * 1e-3).astype(np.float32),
            "b": (rng.normal(size=(64,)) * 20.0).astype(np.float32),
            "z": np.zeros((4, 4), np.float32)}          # the 1e-12 scale floor


@pytest.mark.parametrize("mode", compress.MODES)
def test_compressed_gradients_match_reference(mode):
    """Three steps of the round trip (int8: with its error feedback), each
    decoded gradient and residual bitwise equal to the jitted reference's."""
    params = {k: torch.zeros(v.shape) for k, v in _grad_tree(0).items()}
    state = compress.init_state(params, mode)
    jstate = jcompress.init_state(jax.tree_util.tree_map(jnp.asarray, _grad_tree(0)), mode)
    jfn = jax.jit(jcompress.compressed_gradients, static_argnums=2)
    for step in range(3):
        g = _grad_tree(10 + step)
        dec, state = compress.compressed_gradients(
            {k: torch.from_numpy(v.copy()) for k, v in g.items()}, state, mode)
        jdec, jstate = jfn(jax.tree_util.tree_map(jnp.asarray, g), jstate, mode)
        for k in g:
            assert dec[k].dtype == torch.float32
            assert np.array_equal(bits(dec[k]), bits(jdec[k])), (step, k)
            if mode == "int8":
                assert np.array_equal(bits(state.error[k]), bits(jstate.error[k])), (step, k)
        if mode == "int8":
            assert not np.array_equal(bits(dec["a"]), bits(torch.from_numpy(g["a"])))
    assert (state.error is None) == (mode != "int8")
    with pytest.raises(ValueError, match="compression mode"):
        compress.compressed_gradients({}, state, "fp8")


def test_int8_chunked_pass_equals_the_unchunked_rule(monkeypatch):
    """The int8 pass walks each tensor in chunks of ``compress.CHUNK``
    elements; on a tensor of three whole chunks and a ragged tail (and a
    float32 and a bf16 gradient) two steps give the decoded gradient and
    the residual of the unchunked rule bit for bit: the whole tensor's
    scale, one rounding of ``(g + e) - q·scale`` from float64."""
    monkeypatch.setattr(compress, "CHUNK", 1000)
    rng = np.random.default_rng(4)
    shapes = {"w": (3, 1000 + 250), "h": (37, 101)}       # 3750 and 3737 elements

    def unchunked(g, e):
        e = e + g.float()
        scale = torch.clamp(e.abs().amax(), min=1e-12) / 127.0
        q = torch.round(e / scale).clamp(-127, 127).to(torch.int8)
        dec = q.float() * scale
        return dec, (e.double() - q.double() * scale.double()).float()

    state = compress.init_state({k: torch.zeros(s) for k, s in shapes.items()}, "int8")
    err = {k: torch.zeros(s) for k, s in shapes.items()}
    for step in range(2):
        g = {k: torch.from_numpy((rng.normal(size=s) * 10.0 ** -step).astype(np.float32))
             for k, s in shapes.items()}
        g["h"] = g["h"].to(torch.bfloat16)
        want = {k: unchunked(v, err[k]) for k, v in g.items()}
        dec, state = compress.compressed_gradients({k: v.clone() for k, v in g.items()},
                                                   state, "int8")
        for k, (wd, we) in want.items():
            assert dec[k].dtype == torch.float32
            assert np.array_equal(bits(dec[k]), bits(wd)), (step, k)
            assert np.array_equal(bits(state.error[k]), bits(we)), (step, k)
            err[k] = we


# ---------------------------------------------------------------------------
# LM.loss
# ---------------------------------------------------------------------------

LOSS_CASES = {
    # name: (compute dtype, ce_chunk, checkpointed CE chunks)
    "float32-chunked": ("float32", 64, 2),
    "float32-unchunked": ("float32", 0, 0),
    "bfloat16-chunked": ("bfloat16", 64, 2),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_lm_loss_matches_reference(case, monkeypatch):
    """``LM.loss`` at a constant threshold where blocks die, against the
    jitted reference's ``value_and_grad``: banded local and chunked global
    attention both run (S 128 > window 32 and > attn_chunk 64); with
    ce_chunk 64 the CE runs as two checkpointed chunks. Float32: loss,
    zero_frac and every gradient; bf16: loss and zero_frac, looser."""
    dt, chunk, n_chunks = LOSS_CASES[case]
    kw = dict(compute_dtype=dt, zebra_t_obj=T_OBJ, zebra_tnet=False, ce_chunk=chunk)
    jcfg, tcfg = _cfgs(**kw)
    jm = JLM(jcfg)
    params = jax_lm_params(jcfg)
    tokens = _tokens(jcfg.vocab)
    loss_fn = lambda p, t: jm.loss(p, t, "train")  # noqa: E731
    model = from_jax_params(LM(tcfg), _np(params))
    calls = []
    inner = model_mod.checkpoint
    monkeypatch.setattr(model_mod, "checkpoint", lambda *a, **k: calls.append(1) or inner(*a, **k))
    if dt == "float32":
        (jl, jmet), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, jnp.asarray(tokens))
        grads, loss, m = steps.accumulate_gradients(model, dict(model.named_parameters()),
                                                    torch.from_numpy(tokens).long())
    else:
        jl, jmet = jax.jit(loss_fn)(params, jnp.asarray(tokens))
        with torch.no_grad():
            loss, m = model.loss(torch.from_numpy(tokens).long())
    assert len(calls) == n_chunks
    assert 0.3 < float(m["zero_frac"]) < 0.7
    if dt == "float32":
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        np.testing.assert_allclose(float(m["ce"]), float(jmet["ce"]), rtol=1e-5)
        assert np.array_equal(bits(m["zero_frac"]), bits(jmet["zero_frac"]))
        assert float(m["zebra_reg"]) == float(jmet["zebra_reg"])
        _grads_close(model, grads, jg)
    else:
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-3)
        assert round((float(jmet["zero_frac"]) - float(m["zero_frac"])) * 384) == 1
    assert int(m["measured_bytes"]) == 0 and m["measured_bytes"].dtype == torch.int64


# ---------------------------------------------------------------------------
# Whole train steps
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_init(cfg: JLMConfig, lr: tuple):
    """The reference's initial train state (``make_train_state_shape``'s
    ``init_fn`` from key 0); the site backend and K do not change it."""
    _, init_fn = make_train_state_shape(JLM(cfg), joptim.adamw(joptim.warmup_cosine(*lr)))
    return jax.jit(init_fn)(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def jax_steps(cfg: JLMConfig, tokens_key: tuple, n_steps: int = 2, lr=(1e-3, 1, 10)):
    """The reference's initial params and its metrics and params after each
    of ``n_steps`` jitted steps (bf16 gradient compression, clip 1.0)."""
    tokens = jnp.asarray(np.array(tokens_key[1], np.int32).reshape(tokens_key[0]))
    model = JLM(cfg)
    opt = joptim.adamw(joptim.warmup_cosine(*lr))
    state = jax_init(cfg.replace(zebra_backend="reference", grad_accum=1), lr)
    step = jax.jit(make_train_step(model, opt, make_host_mesh(model=1)))
    out = [(_np(state["params"]), None)]
    for _ in range(n_steps):
        state, m = step(state, {"tokens": tokens})
        out.append((_np(state["params"]), _np(m)))
    return out


def _key(tokens):
    return (tokens.shape, tuple(tokens.reshape(-1).tolist()))


def port_steps(tcfg: LMConfig, init_params, tokens, n_steps: int = 2, lr=(1e-3, 1, 10)):
    """The port's metrics per step from the reference's initial params,
    the trained model, and the site backends that ran (the FFN's sites and
    the enabled ``layer_out`` sites)."""
    import repro_torch.models.lm.blocks as blocks
    import repro_torch.models.lm.ffn as ffn
    model = from_jax_params(LM(tcfg), init_params)
    opt = optim.adamw(optim.warmup_cosine(*lr))
    state = steps.init_train_state(model, opt)
    labels, inner = [], (ffn.zebra_site, blocks.zebra_site)

    def recorded(fn):
        def site(x, cfg, **kw):
            y, aux = fn(x, cfg, **kw)
            if cfg.enabled:
                labels.append(aux.backend)
            return y, aux
        return site
    ffn.zebra_site, blocks.zebra_site = map(recorded, inner)
    try:
        ms = []
        for _ in range(n_steps):
            state, m = steps.train_step(model, opt, state,
                                        {"tokens": torch.from_numpy(tokens).long()})
            ms.append(m)
    finally:
        ffn.zebra_site, blocks.zebra_site = inner
    assert state["step"] == n_steps
    return ms, model, set(labels)


def _jax_bytes(jm) -> int:
    return int(float(jm["measured_bytes_hi"])) * 2 ** 24 + int(float(jm["measured_bytes_lo"]))


def _metrics_close(m, jm, rtol=1e-5):
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol, err_msg=k)
    # zero_frac is a mean over microbatches (K > 1), each rounded to float32
    np.testing.assert_allclose(float(m["zero_frac"]), float(jm["zero_frac"]), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(float(m["zebra_reg"]), float(jm["zebra_reg"]), rtol=1e-6)
    assert int(m["measured_bytes"]) == _jax_bytes(jm)


STEP_KW = dict(compute_dtype="float32", zebra_t_obj=T_OBJ, zebra_tnet=False, ce_chunk=64)


@functools.lru_cache(maxsize=None)
def port_backend_run(backend):
    jcfg, tcfg = _cfgs(**STEP_KW, zebra_backend=backend)
    tokens = _tokens(jcfg.vocab)
    init = jax_steps(jcfg, _key(tokens))[0][0]
    return port_steps(tcfg, init, tokens)


@pytest.mark.parametrize("backend", ["reference", "pallas", "stream"])
def test_train_step_matches_reference(backend):
    """Two steps of ``train_step`` against ``jax.jit(make_train_step)`` on
    the same backend, at T_obj 2.45 (zero fraction 0.589): the metrics of
    each step and the parameters after both (the first step's lr is 0
    under the warm-up, so the second moves them). On ``stream`` the bytes
    are exact and nonzero; every site ran the requested backend."""
    jcfg, tcfg = _cfgs(**STEP_KW, zebra_backend=backend)
    tokens = _tokens(jcfg.vocab)
    jout = jax_steps(jcfg, _key(tokens))
    ms, model, labels = port_backend_run(backend)
    assert labels == {backend}
    for m, (_, jm) in zip(ms, jout[1:]):
        _metrics_close(m, jm)
        assert 0.3 < float(m["zero_frac"]) < 0.7
        assert (int(m["measured_bytes"]) > 0) == (backend == "stream")
    _params_close(model, jout[-1][0], atol=1e-4)


# the reduced recurrent architectures on stream: mamba2's one site is
# layer_out (the residual stream plus the SSD's output; zero fraction 0.47
# in the forward at 4.75), recurrentgemma's ffn_hidden (two RG-LRU layers
# and one local attention layer, S 128 > window 32)
ARCH_T_OBJ = {"mamba2-2.7b": 4.75, "recurrentgemma-2b": 2.45}


@pytest.mark.parametrize("arch", list(ARCH_T_OBJ))
def test_recurrent_arch_train_step_matches_reference(arch):
    """Two ``train_step``s of the reduced mamba2-2.7b and recurrentgemma-2b on
    ``stream`` against the jitted reference's on ``stream``: the metrics of
    each step (the stream bytes exact), the parameters after both, every
    site on ``stream``."""
    kw = dict(STEP_KW, zebra_t_obj=ARCH_T_OBJ[arch], zebra_backend="stream")
    jcfg, tcfg = jconfigs.reduced(arch).replace(**kw), configs.reduced(arch).replace(**kw)
    tokens = _tokens(jcfg.vocab)
    jout = jax_steps(jcfg, _key(tokens))
    ms, model, labels = port_steps(tcfg, jout[0][0], tokens)
    assert labels == {"stream"}
    for m, (_, jm) in zip(ms, jout[1:]):
        _metrics_close(m, jm)
        assert 0.2 < float(m["zero_frac"]) < 0.8 and int(m["measured_bytes"]) > 0
    _params_close(model, jout[-1][0], atol=1e-4)


def test_port_backends_train_bitwise():
    """reference, pallas and stream train the same bits: the metrics of both
    steps and every parameter (the stream bytes aside)."""
    runs = {b: port_backend_run(b) for b in ("reference", "pallas", "stream")}
    ref_ms, ref_model, _ = runs["reference"]
    for b in ("pallas", "stream"):
        ms, model, _ = runs[b]
        for m, rm in zip(ms, ref_ms):
            for k in ("loss", "ce", "zebra_reg", "zero_frac", "grad_norm"):
                assert np.array_equal(bits(m[k]), bits(rm[k])), (b, k)
        for k, v in ref_model.state_dict().items():
            assert np.array_equal(bits(model.state_dict()[k]), bits(v)), (b, k)


def test_grad_accum_bytes_exact_and_k_invariant():
    """``tests/test_grad.py``'s check at a threshold where blocks die: on
    ``stream`` with grad_accum 2 (microbatches of one row) the two steps
    match the reference's with K 2, and the bytes are equal to its ``hi *
    2**24 + lo`` and to the port's with K 1 (extensive: the whole batch's
    bytes, whatever K)."""
    jcfg, tcfg = _cfgs(**STEP_KW, zebra_backend="stream", grad_accum=2)
    tokens = _tokens(jcfg.vocab)
    jout = jax_steps(jcfg, _key(tokens))
    ms, model, labels = port_steps(tcfg, jout[0][0], tokens)
    assert labels == {"stream"}
    for m, (_, jm) in zip(ms, jout[1:]):
        _metrics_close(m, jm)
        assert 0.3 < float(m["zero_frac"]) < 0.7
    _params_close(model, jout[-1][0], atol=1e-4)
    k1 = port_backend_run("stream")[0]
    assert [int(m["measured_bytes"]) for m in ms] == [int(m["measured_bytes"]) for m in k1]
    assert min(int(m["measured_bytes"]) for m in ms) > 0


def test_grad_accum_splits_rows_in_order():
    """K microbatches are rows [i·B/K, (i+1)·B/K): the accumulated gradient
    is the mean of the per-microbatch gradients, summed in order."""
    _, tcfg = _cfgs(zebra_t_obj=T_OBJ, zebra_tnet=False)
    tokens = torch.from_numpy(_tokens(tcfg.vocab, batch=4, seq=32)).long()
    model = LM(tcfg, generator=torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    g2, l2, m2 = steps.accumulate_gradients(model, params, tokens)
    model.cfg = tcfg.replace(grad_accum=2)
    g, l, m = steps.accumulate_gradients(model, params, tokens)
    model.cfg = tcfg
    parts = [steps.accumulate_gradients(model, params, tokens[i:i + 2]) for i in (0, 2)]
    for k in params:
        assert np.array_equal(bits(g[k]), bits((parts[0][0][k] + parts[1][0][k]) / 2)), k
    assert np.array_equal(bits(l), bits((parts[0][1] + parts[1][1]) / 2))
    assert int(m["measured_bytes"]) == sum(int(p[2]["measured_bytes"]) for p in parts)
    np.testing.assert_allclose(float(l), float(l2), rtol=1e-5)
    with pytest.raises(ValueError, match="grad_accum"):
        model.cfg = tcfg.replace(grad_accum=3)
        steps.accumulate_gradients(model, params, tokens)


def test_tnet_training_with_layer_out_matches_reference():
    """Eq. 1: threshold nets at ``ffn_hidden`` and ``layer_out`` (T_obj
    1.0), asked for ``pallas``: every site resolves to reference(tnet), and
    two steps match the reference's (loss, the nets' L2 term, grad norm,
    parameters and the nets' weights)."""
    kw = dict(compute_dtype="float32", zebra_t_obj=1.0, zebra_tnet=True, ce_chunk=64,
              zebra_sites=("ffn_hidden", "layer_out"), zebra_backend="pallas")
    jcfg, tcfg = _cfgs(**kw)
    tokens = _tokens(jcfg.vocab)
    jout = jax_steps(jcfg, _key(tokens))
    ms, model, labels = port_steps(tcfg, jout[0][0], tokens)
    assert labels == {"reference(tnet)"}
    assert any(k.endswith("zebra_out_tnet.w") for k in model.state_dict())
    for m, (_, jm) in zip(ms, jout[1:]):
        _metrics_close(m, jm)
        assert float(m["zebra_reg"]) > 0 and float(m["loss"]) > float(m["ce"])
    _params_close(model, jout[-1][0], atol=1e-4)


def test_fused_train_resolves_to_reference_not_trainable():
    """``fused`` in train mode degrades to reference(not-trainable) and the
    FFN keeps its dense ``w_down`` product, as in the reference."""
    jcfg, tcfg = _cfgs(compute_dtype="float32", zebra_t_obj=T_OBJ, zebra_tnet=False,
                       zebra_backend="fused")
    model = from_jax_params(LM(tcfg), _np(jax_lm_params(jcfg)))
    p = model.run0[0]["sub0"].ffn
    rng = np.random.default_rng(1)          # one scale per 8-row block: some die
    scale = np.repeat(rng.choice([0.05, 4.0], size=(2, 2, 1)), 8, axis=1)
    x = (rng.normal(size=(2, 16, tcfg.d_model)) * scale).astype(np.float32)
    y, aux = ffn_apply(p, torch.from_numpy(x), tcfg, "train")
    y_ref, aux_ref = ffn_apply(p, torch.from_numpy(x), tcfg.replace(zebra_backend="reference"),
                               "train")
    jp = {k: jnp.asarray(v.detach().numpy()) for k, v in p.named_parameters()}
    jy, jaux = jffn_apply(jp, jnp.asarray(x), jcfg, "train")
    assert aux.backend == jaux.backend == "reference(not-trainable)"
    assert 0.0 < float(aux.zero_frac) < 1.0
    assert np.array_equal(bits(y), bits(y_ref))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_bench_lm_2l_64d_matches_reference(backend):
    """``benchmarks/train_bench.py``'s lm rows (``lm-2l-64d``: 2 layers, d
    64, T_obj 0.5, bf16 compute, AdamW warmup_cosine(1e-3, 2, 20), the same
    batch twice) against the reference's step: what the row records (loss,
    grad_norm, zero_frac), at rtol 1e-4 in bf16 (2e-5 and 4e-5 seen). The
    parameters are not compared: in bf16 a few gradients near zero take the
    other sign, which Adam's first update turns into a step of 2·lr. At
    T_obj 0.5 no block of that map dies (zero_frac 0.0 in both), so the
    masking gates nothing there: the threshold cases above are the ones
    where it does."""
    kw = dict(name="bench", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256,
              vocab=256, zebra_t_obj=0.5, zebra_backend=backend, zebra_tnet=False)
    jcfg, tcfg = JLMConfig(**kw), LMConfig(**kw)
    tokens = _tokens(256, batch=2, seq=32)
    lr = (1e-3, 2, 20)
    jout = jax_steps(jcfg, _key(tokens), lr=lr)
    ms, _, labels = port_steps(tcfg, jout[0][0], tokens, lr=lr)
    assert labels == {backend}
    for m, (_, jm) in zip(ms, jout[1:]):
        _metrics_close(m, jm, rtol=1e-4)
        assert float(m["zero_frac"]) == float(jm["zero_frac"]) == 0.0


# ---------------------------------------------------------------------------
# The in-place optimizers
# ---------------------------------------------------------------------------

def _rand_params(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(37, 19, generator=g), "b": torch.randn(64, generator=g) * 1e-3,
            "h": torch.randn(8, 8, generator=g).to(torch.bfloat16)}


@pytest.mark.parametrize("name", ["sgd", "sgd-nesterov", "adamw"])
def test_in_place_update_matches_functional(name):
    """``update_`` writes the same bits into the parameters and the state as
    ``update`` + ``apply_updates`` give, over 3 steps, and leaves the
    gradients as they were."""
    opt = {"sgd": optim.sgd(optim.step_decay(0.1, total_steps=3)),
           "sgd-nesterov": optim.sgd(optim.cosine(0.1, 3), nesterov=True),
           "adamw": optim.adamw(optim.warmup_cosine(1e-2, 1, 3))}[name]
    fp = _rand_params(0)
    ip = {k: v.clone() for k, v in fp.items()}
    fs, is_ = opt.init(fp), opt.init(ip)
    for step in range(3):
        grads = {k: v.float() * (step + 1) for k, v in _rand_params(10 + step).items()}
        before = {k: v.clone() for k, v in grads.items()}
        upd, fs = opt.update(grads, fs, fp, step)
        fp = optim.apply_updates(fp, upd)
        opt.update_(grads, is_, ip, step)
        for k in fp:
            assert ip[k].dtype == fp[k].dtype
            assert np.array_equal(bits(ip[k]), bits(fp[k])), (step, k)
            assert np.array_equal(bits(grads[k]), bits(before[k])), (step, k)
        for slot in fs:
            for k in fs[slot]:
                assert np.array_equal(bits(is_[slot][k]), bits(fs[slot][k])), (step, slot, k)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_in_place_matches_functional(max_norm):
    grads = {k: v.float() for k, v in _rand_params(3).items()}
    want, norm = optim.clip_by_global_norm(grads, max_norm)
    got = {k: v.clone() for k, v in grads.items()}
    assert np.array_equal(bits(optim.clip_by_global_norm_(got, max_norm)), bits(norm))
    for k in grads:
        assert np.array_equal(bits(got[k]), bits(want[k])), k


def test_train_step_refuses_foreign_params():
    _, tcfg = _cfgs(zebra_tnet=False)
    model, other = LM(tcfg), LM(tcfg)
    opt = optim.adamw(optim.constant(1e-3))
    state = steps.init_train_state(other, opt)
    with pytest.raises(ValueError, match="own parameters"):
        steps.train_step(model, opt, state, {"tokens": torch.zeros(2, 9, dtype=torch.int64)})
