"""``LMConfig.remat`` in the port: ``none``, ``block`` and ``save_acts`` give
the same loss, metrics and gradients bit for bit (recomputation runs the
same ops on the same inputs), and each equals the reference's jitted
``value_and_grad`` under the same remat at the LM tests' tolerances
(loss rtol 1e-5, gradients atol 1e-6, ``zero_frac`` bitwise). Without
gradients a unit is a plain call, so serving does not change.

The reduced gemma3-4b with a 512-token vocabulary (the CE's cost is the
vocabulary's; the layers are the reduced config's), float32 at T_obj 2.45
where blocks die, unless a case says otherwise; the ``moe`` case is the
reduced granite-moe-1b-a400m (its ``router_aux`` is a metric, and part of
the loss, and must not count twice when a unit is recomputed), the
``whisper`` case the reduced whisper-medium with frames ~ N(0, 0.1²)
(each encoder layer one more unit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models.lm import LM as JLM
from repro_torch import configs
from repro_torch.data import LMDatasetConfig, lm_batch
from repro_torch.launch import steps
from repro_torch.models.lm import LM, remat
from repro_torch.models.lm.convert import from_jax_params, port_params

from _torch_parity import bits, jax_lm_params, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

BASE = dict(vocab=512, zebra_t_obj=2.45, zebra_tnet=False, ce_chunk=64,
            compute_dtype="float32")
CASES = {"reference": {}, "pallas": dict(zebra_backend="pallas"),
         "stream": dict(zebra_backend="stream"),
         "tnet": dict(zebra_tnet=True, zebra_t_obj=1.0),
         "bf16-stream": dict(zebra_backend="stream", compute_dtype="bfloat16"),
         "grad-accum-2": dict(zebra_backend="stream", grad_accum=2),
         "moe": dict(arch="granite-moe-1b-a400m", zebra_backend="stream", zebra_t_obj=0.025),
         "whisper": dict(arch="whisper-medium", zebra_backend="stream", zebra_t_obj=2.5)}


def _tokens(vocab, batch=2, seq=128):
    return torch.from_numpy(lm_batch(LMDatasetConfig(vocab=vocab), batch, seq, 0)).long()


def _grads(cfg, monkeypatch=None):
    model = LM(cfg, generator=torch.Generator().manual_seed(0))
    frames = None
    if cfg.encoder_layers:
        rng = np.random.default_rng(5)
        frames = torch.from_numpy((rng.normal(size=(2, cfg.enc_seq, cfg.d_model)) * 0.1)
                                  .astype(np.float32))
    return steps.accumulate_gradients(model, dict(model.named_parameters()),
                                      _tokens(cfg.vocab), frames)


def _case_cfg(case):
    kw = dict(CASES[case])
    return configs.reduced(kw.pop("arch", "gemma3-4b")).replace(**{**BASE, **kw})


@pytest.mark.parametrize("case", list(CASES))
def test_remat_modes_bitwise(case, monkeypatch):
    cfg = _case_cfg(case)
    calls = []
    inner = remat.checkpoint
    monkeypatch.setattr(remat, "checkpoint",
                        lambda *a, **k: calls.append(k.get("context_fn")) or inner(*a, **k))
    runs = {}
    for mode in remat.REMATS:
        calls.clear()
        runs[mode] = _grads(cfg.replace(remat=mode))
        # a unit per repeat of the pattern (the reduced gemma3-4b: one of 6
        # layers) and per encoder layer, per microbatch
        repeats = cfg.n_layers // len(cfg.layer_pattern) + cfg.encoder_layers
        assert len(calls) == (0 if mode == "none" else repeats * cfg.grad_accum), mode
        assert all((c is None) == (mode == "block") for c in calls), mode
    g0, l0, m0 = runs["none"]
    assert (float(m0["router_aux"]) > 0) == (case == "moe")
    if case in ("moe", "whisper"):
        assert 0.0 < float(m0["zero_frac"]) < 1.0 and int(m0["measured_bytes"]) > 0
    for mode in ("block", "save_acts"):
        g, l, m = runs[mode]
        assert np.array_equal(bits(l), bits(l0)), mode
        for k in m0:
            assert np.array_equal(bits(m[k]), bits(m0[k])), (mode, k)
        bad = [k for k in g0 if not np.array_equal(bits(g[k]), bits(g0[k]))]
        assert not bad, (mode, bad[:4])


def test_save_acts_keeps_the_named_maps(monkeypatch):
    """Under ``save_acts`` the two named maps of every layer go through the
    ``checkpoint_name`` op, in the forward and again in the recompute
    (where the policy hands back the saved map); under ``block`` never."""
    cfg = configs.reduced("gemma3-4b").replace(**BASE)
    seen = []
    inner = remat._named
    monkeypatch.setattr(remat, "_named", lambda x, name: seen.append(name) or inner(x, name))
    _grads(cfg.replace(remat="block"))
    assert seen == []
    _grads(cfg.replace(remat="save_acts"))
    assert seen.count("attn_out") == seen.count("ffn_hidden") == 2 * cfg.n_layers


@pytest.mark.parametrize("mode", remat.REMATS)
def test_remat_matches_reference(mode):
    """The port's step-1 gradients under ``mode`` against the reference's
    jitted ``value_and_grad`` under the same remat."""
    kw = dict(BASE, remat=mode)
    jcfg = jconfigs.reduced("gemma3-4b").replace(**kw)
    cfg = configs.reduced("gemma3-4b").replace(**kw)
    jm = JLM(jcfg)
    params = jax_lm_params(jcfg)
    tokens = _tokens(cfg.vocab)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(lambda p, t: jm.loss(p, t, "train"),
                                                has_aux=True))(params, jnp.asarray(tokens))
    model = from_jax_params(LM(cfg), jax.tree_util.tree_map(np.asarray, params))
    grads, loss, m = steps.accumulate_gradients(model, dict(model.named_parameters()), tokens)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert np.array_equal(bits(m["zero_frac"]), bits(jmet["zero_frac"]))
    assert 0.3 < float(m["zero_frac"]) < 0.7
    want = port_params(model, jax.tree_util.tree_map(np.asarray, jg))
    for k, v in want.items():
        np.testing.assert_allclose(grads[k].numpy(), v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_without_gradients_a_unit_is_a_plain_call(monkeypatch):
    """Under ``torch.no_grad`` and inference mode (serving) no unit is
    checkpointed, whatever ``remat`` says, and the prefill does not change."""
    cfg = configs.reduced("gemma3-4b").replace(**BASE, zebra_backend="stream")
    calls = []
    monkeypatch.setattr(remat, "checkpoint", lambda *a, **k: calls.append(1))
    model = LM(cfg, generator=torch.Generator().manual_seed(0))
    tokens = _tokens(cfg.vocab)[:, :-1]
    outs = {}
    for mode in remat.REMATS:
        model.cfg = cfg.replace(remat=mode)
        with torch.no_grad():
            loss, _ = model.loss(_tokens(cfg.vocab))
        outs[mode] = (loss, steps.prefill(model, tokens)[0])
    assert calls == []
    for mode in ("block", "save_acts"):
        assert torch.equal(outs[mode][0], outs["none"][0])
        assert torch.equal(outs[mode][1], outs["none"][1])


def test_unknown_remat_raises():
    cfg = configs.reduced("gemma3-4b").replace(**BASE, remat="everything")
    with pytest.raises(ValueError, match="remat"):
        _grads(cfg)
