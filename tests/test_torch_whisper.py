"""whisper-medium's encoder-decoder in the port against the reference, at
the reduced config (2 encoder + 2 decoder layers, d 128, 4 heads, d_ff
256, 64 frames) with float32 compute, every bias drawn from numpy (the
reference initialises them to zero) and frames ``enc_feats`` ~ N(0, 0.1²):

* the forward, the prefill and one decode step after it (the decoder's
  cross-attention recomputes the encoder's K and V at every step, as the
  reference does): logits allclose at rtol/atol 1e-4, the forward's
  zero fraction, encoder and decoder sites together, bitwise;
* the non-causal ``attend_full`` with T != S against the reference's
  ``attend_full(causal=False)`` (rtol/atol 1e-6);
* two train steps with the frames split over two microbatches like the
  tokens, against ``jax.jit(make_train_step)``: the tolerances of
  ``test_torch_lm_train.py`` (loss rtol 1e-5, parameters atol 1e-4);
* a frame count that is no multiple of ``block_seq`` (whisper's 1500)
  sends every encoder site to ``reference(degenerate-rows)``.
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
from repro.models.lm.attention import attend_full as jattend_full
from repro_torch import configs, optim
from repro_torch.data import LMDatasetConfig, lm_batch
from repro_torch.launch import steps
from repro_torch.models.lm import LM
from repro_torch.models.lm.attention import attend_full
from repro_torch.models.lm.convert import from_jax_params, port_params

from _torch_parity import bits

ARCH = "whisper-medium"
T_OBJ = 2.5
KW = dict(param_dtype="float32", compute_dtype="float32", zebra_t_obj=T_OBJ,
          zebra_tnet=False)


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a.detach().float() if isinstance(a, torch.Tensor)
                                          else a), np.asarray(b, np.float32), **tol)


def cfgs(**kw):
    kw = {**KW, **kw}
    return jconfigs.reduced(ARCH).replace(**kw), configs.reduced(ARCH).replace(**kw)


def frames(batch, seed=7, n=None):
    cfg = configs.reduced(ARCH)
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, n or cfg.enc_seq, cfg.d_model)) * 0.1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def reference_params():
    """The reference's init (key 1) with every bias drawn from numpy."""
    jcfg, _ = cfgs()
    params = jax.jit(JLM(jcfg).init)(jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)

    def draw(path, leaf):
        if getattr(path[-1], "key", None) in ("bq", "bk", "bv", "b_up", "b_down"):
            return (rng.normal(size=leaf.shape) * 0.5).astype(np.float32)
        return np.asarray(leaf)
    return jax.tree_util.tree_map_with_path(draw, params)


def test_forward_prefill_decode_match_reference():
    jcfg, tcfg = cfgs()
    params = reference_params()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    toks = lm_batch(LMDatasetConfig(vocab=jcfg.vocab), 2, 32, 1)[:, :32]
    S0 = 16
    ef = frames(2)
    jm = JLM(jcfg)
    jlogits, jaux = jax.jit(lambda p, t, e: jm.forward(p, t, "infer", e))(
        jp, jnp.asarray(toks), jnp.asarray(ef))
    jl0, jstate, _ = jax.jit(lambda p, t, e: jm.prefill(p, t, 32, e))(
        jp, jnp.asarray(toks[:, :S0]), jnp.asarray(ef))
    jl1, _ = jax.jit(jm.decode_step)(jp, jnp.asarray(toks[:, S0:S0 + 1]), jstate,
                                     jnp.int32(S0))
    model = from_jax_params(LM(tcfg), params)
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        logits, aux = model(t, "infer", torch.from_numpy(ef))
        l0, state, _ = model.prefill(t[:, :S0], 32, torch.from_numpy(ef))
        enc_out = state[1]
        l1, state = model.decode_step(t[:, S0:S0 + 1], state, S0)
    close(logits, jlogits, rtol=1e-4, atol=1e-4)
    assert np.array_equal(bits(aux.zero_frac), bits(jaux.zero_frac))
    assert 0.0 < float(aux.zero_frac) < 1.0
    assert float(aux.n_blocks) == float(jaux.n_blocks)
    close(l0, jl0, rtol=1e-4, atol=1e-4)
    close(enc_out, jstate[1], rtol=1e-4, atol=1e-4)
    close(l1, jl1, rtol=1e-4, atol=1e-4)
    assert state[1] is enc_out          # decode passes the encoder output on
    # the decoder without frames: no encoder runs, no cross-attention
    with torch.no_grad():
        bare, _ = model(t, "infer")
    jbare, _ = jax.jit(lambda p, t: jm.forward(p, t, "infer"))(jp, jnp.asarray(toks))
    close(bare, jbare, rtol=1e-4, atol=1e-4)
    assert not np.allclose(bare.numpy(), logits.numpy(), atol=1e-3)


@pytest.mark.parametrize("T", [5, 24])
def test_attend_full_noncausal_matches_reference(T):
    """Cross-attention's shape: S queries over T != S keys, GQA 8 / 2 heads,
    every key visible."""
    rng = np.random.default_rng(T)
    q = rng.normal(size=(2, 16, 8, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, T, 2, 32)).astype(np.float32) for _ in range(2))
    got = attend_full(*(torch.from_numpy(a) for a in (q, k, v)), causal=False)
    want = jattend_full(*(jnp.asarray(a) for a in (q, k, v)), causal=False)
    close(got, want, rtol=1e-6, atol=1e-6)


def test_train_steps_with_frames_match_reference():
    """Two AdamW steps (warmup_cosine(1e-3, 1, 10), bf16 gradient
    compression, clip 1.0) on ``reference`` at T_obj 2.5 where blocks die,
    batch 2 in two microbatches with their frames split like the tokens;
    the first step's lr is 0 under the warm-up, the second moves the
    parameters."""
    jcfg, tcfg = cfgs(grad_accum=2)
    tokens = lm_batch(LMDatasetConfig(vocab=jcfg.vocab), 2, 32, 0)
    ef = frames(2, seed=11)
    lr = (1e-3, 1, 10)
    jmodel = JLM(jcfg)
    jopt = joptim.adamw(joptim.warmup_cosine(*lr))
    _, init_fn = make_train_state_shape(jmodel, jopt)
    jstate = jax.jit(init_fn)(jax.random.PRNGKey(0))
    model = from_jax_params(LM(tcfg), jax.tree_util.tree_map(np.asarray, jstate["params"]))
    jstep = jax.jit(make_train_step(jmodel, jopt, make_host_mesh(model=1)))
    opt = optim.adamw(optim.warmup_cosine(*lr))
    state = steps.init_train_state(model, opt)
    batch = {"tokens": torch.from_numpy(tokens).long(), "enc_feats": torch.from_numpy(ef)}
    for _ in range(2):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens), "enc_feats": jnp.asarray(ef)})
        state, m = steps.train_step(model, opt, state, batch)
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(float(m["zero_frac"]), float(jm["zero_frac"]), rtol=1e-6)
        assert 0.0 < float(m["zero_frac"]) < 1.0 and float(m["router_aux"]) == 0.0
    for key, want in port_params(model, jax.tree_util.tree_map(np.asarray,
                                                               jstate["params"])).items():
        np.testing.assert_allclose(model.state_dict()[key].numpy(), want, rtol=1e-4,
                                   atol=1e-4, err_msg=key)


def test_encoder_sites_degenerate_at_an_odd_frame_count(monkeypatch):
    """60 frames (like whisper's 1500, no multiple of block_seq 8): every
    encoder ``ffn_hidden`` site runs ``reference(degenerate-rows)`` on a
    kernel backend, the decoder's sites the backend asked for."""
    import repro_torch.models.lm.ffn as ffn
    _, tcfg = cfgs(zebra_backend="fused", zebra_sites=("ffn_hidden", "kv_cache"))
    model = LM(tcfg, generator=torch.Generator().manual_seed(0)).requires_grad_(False)
    labels, inner = [], ffn.zebra_site

    def site(x, cfg, **kw):
        y, aux = inner(x, cfg, **kw)
        labels.append((x.shape[-2], aux.backend))
        return y, aux
    monkeypatch.setattr(ffn, "zebra_site", site)
    toks = torch.from_numpy(lm_batch(LMDatasetConfig(vocab=tcfg.vocab), 2, 16, 0)[:, :16])
    model.prefill(toks.long(), 16, torch.from_numpy(frames(2, n=60)))
    assert labels == [(60, "reference(degenerate-rows)")] * 2 + [(16, "fused")] * 2
