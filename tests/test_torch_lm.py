"""The port's LM stack on the CPU against the reference package: norms,
RoPE, each attention path, the FFN on the ``fused`` backend, and the
serving slice as a whole (reduced gemma3-4b with 13 layers, so one run
repeats twice and one is a remainder: prefill, the compressed KV
handoff, 4 greedy tokens).

Inputs come from numpy seeds; the reference's weights cross with
``models.lm.convert.from_jax_params``. Tolerances: the pieces compare in
float32 at rtol/atol 1e-5 (the same products summed in another order);
the slice runs at ``compute_dtype="float32"`` and its logits are allclose
at rtol/atol 1e-4 after 13 layers. Bitmaps, byte counts, the meter's
records and totals, and the greedy tokens are exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.compress import BandwidthMeter as JMeter
from repro.compress import compress_tree as jcompress_tree
from repro.launch.mesh import make_host_mesh
from repro.launch.serve import model_prefill_pad as jprefill_pad
from repro.launch.steps import make_generate, make_prefill
from repro.models import layers as jlayers
from repro.models.lm import LM as JLM
from repro.models.lm import attention as jattn
from repro.models.lm.ffn import ffn_apply as jffn_apply
from repro.models.lm.ffn import ffn_init as jffn_init
from repro_torch import configs
from repro_torch.data import LMDatasetConfig, lm_batch
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models.lm import LM, attention as attn
from repro_torch.models.lm.convert import from_jax_params, port_params
from repro_torch.models.lm.ffn import FFN, ffn_apply

from _torch_parity import bits

TOL = dict(rtol=1e-5, atol=1e-5)


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a.float() if isinstance(a, torch.Tensor) else a),
                               np.asarray(b, np.float32), **(tol or TOL))


# ---------------------------------------------------------------------------
# Module-level pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_norms_match_reference(dt):
    x = rand((2, 5, 64), 0, 3.0)
    scale, bias = rand((64,), 1), rand((64,), 2)
    xt = torch.from_numpy(x).to(getattr(torch, dt))
    xj = jnp.asarray(x, dt)
    got = layers.rmsnorm_apply(torch.from_numpy(scale), xt)
    want = jlayers.rmsnorm_apply({"scale": jnp.asarray(scale)}, xj)
    tol = TOL if dt == "float32" else dict(rtol=1e-2, atol=1e-2)
    assert got.dtype == xt.dtype
    close(got, want, **tol)
    got = layers.layernorm_apply(torch.from_numpy(scale), torch.from_numpy(bias), xt)
    want = jlayers.layernorm_apply({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, xj)
    close(got, want, **tol)


def test_rope_matches_reference():
    cos, sin = attn.rope_frequencies(32, 1e6, torch.arange(12))
    jcos, jsin = jattn.rope_frequencies(32, 1e6, jnp.arange(12))
    close(cos, jcos)
    close(sin, jsin)
    x = rand((2, 12, 3, 32), 3)
    close(attn.apply_rope(torch.from_numpy(x), cos, sin),
          jattn.apply_rope(jnp.asarray(x), jcos, jsin))


def qkv(B, S, T, Hq, Hkv, hd, seed):
    return (rand((B, S, Hq, hd), seed), rand((B, T, Hkv, hd), seed + 1),
            rand((B, T, Hkv, hd), seed + 2))


@pytest.mark.parametrize("path", ["full-causal", "full-window", "chunked", "local", "decode",
                                  "decode-ring"])
def test_attention_paths_match_reference(path):
    B, S, Hq, Hkv, hd = 2, 64, 4, 2, 16
    T = 48 if path.startswith("decode") else S
    q, k, v = qkv(B, 1 if path.startswith("decode") else S, T, Hq, Hkv, hd, 7)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    if path == "full-causal":
        got, want = attn.attend_full(tq, tk, tv), jattn.attend_full(jq, jk, jv, causal=True)
    elif path == "full-window":
        got, want = attn.attend_full(tq, tk, tv, window=16), \
            jattn.attend_full(jq, jk, jv, causal=True, window=16)
    elif path == "chunked":
        got, want = attn.attend_chunked(tq, tk, tv, chunk=16), \
            jattn.attend_chunked(jq, jk, jv, chunk=16)
    elif path == "local":
        got, want = attn.attend_local(tq, tk, tv, window=16), \
            jattn.attend_local(jq, jk, jv, window=16)
    elif path == "decode":
        got, want = attn.attend_decode(tq, tk, tv, 30), jattn.attend_decode(jq, jk, jv, 30)
    else:
        got, want = attn.attend_decode(tq, tk, tv, 70, window=48), \
            jattn.attend_decode(jq, jk, jv, 70, window=48)
    close(got, want)


def test_ffn_fused_matches_reference():
    """``ffn_apply`` on ``fused`` from the same input and weights: y
    allclose, the hidden site's observables exact."""
    cfg = jconfigs.reduced("gemma3-4b").replace(zebra_backend="fused", zebra_t_obj=2.0,
                                                compute_dtype="float32")
    tcfg = configs.reduced("gemma3-4b").replace(zebra_backend="fused", zebra_t_obj=2.0,
                                                compute_dtype="float32")
    p = jffn_init(jax.random.PRNGKey(3), cfg, jnp.float32)
    ffn = FFN(tcfg)
    ffn.load_state_dict({"w_gate": torch.tensor(np.array(p["w_gate"])),
                         "w_up": torch.tensor(np.array(p["w_up"])),
                         "w_down": torch.tensor(np.array(p["w_down"])),
                         "zebra_tnet.w": torch.tensor(np.array(p["zebra_tnet"]["w"])),
                         "zebra_tnet.b": torch.tensor(np.array(p["zebra_tnet"]["b"]))})
    x = rand((2, 16, cfg.d_model), 4)
    with torch.no_grad():
        y, aux = ffn_apply(ffn, torch.from_numpy(x), tcfg, "infer")
    jy, jaux = jffn_apply(p, jnp.asarray(x), cfg, "infer")
    close(y, jy)
    assert aux.backend == jaux.backend == "fused"
    assert 0.0 < float(aux.zero_frac) < 1.0
    assert np.array_equal(bits(aux.zero_frac), bits(jaux.zero_frac))
    assert int(aux.measured_bytes) == int(jaux.measured_bytes)


# ---------------------------------------------------------------------------
# The slice: reduced gemma3-4b serving on fused
# ---------------------------------------------------------------------------

B, S, GEN, T_OBJ = 2, 128, 4, 3.0


def slice_cfgs():
    kw = dict(n_layers=13, param_dtype="float32", compute_dtype="float32",
              zebra_sites=("ffn_hidden", "kv_cache"), zebra_t_obj=T_OBJ,
              zebra_backend="fused")
    return jconfigs.reduced("gemma3-4b").replace(**kw), configs.reduced("gemma3-4b").replace(**kw)


@functools.lru_cache(maxsize=None)
def reference_slice():
    """The reference server's one-shot path (``repro.launch.serve.main``):
    prefill, pad, the compressed handoff metered per leaf, 4 greedy tokens."""
    cfg, _ = slice_cfgs()
    mesh = make_host_mesh(model=1)
    model = JLM(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    prompts = jnp.asarray(lm_batch(LMDatasetConfig(vocab=cfg.vocab), B, S, 0)[:, :S])
    logits, (caches, enc), aux = jprefill_pad(jax.jit(make_prefill(model, mesh)), params,
                                             prompts, S + GEN)
    meter = JMeter()
    ccaches = jcompress_tree(caches, bs=cfg.zebra_block_seq, bc=cfg.zebra_block_ch,
                             meter=meter, site="kv")
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    toks, _ = jax.jit(make_generate(model, mesh, GEN - 1))(params, tok, (ccaches, enc),
                                                           jnp.int32(S))
    tokens = np.concatenate([np.asarray(tok), np.asarray(toks)], 1)
    return params, prompts, np.asarray(logits), aux, meter, tokens


def test_from_jax_params_unstacks_runs():
    params = reference_slice()[0]
    _, tcfg = slice_cfgs()
    model = LM(tcfg)
    assert [c for _, c in model.runs] == [2, 1]
    names = port_params(model, jax.tree_util.tree_map(np.asarray, params))
    assert set(names) == set(model.state_dict())
    from_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    wq = np.asarray(params["run0"]["sub5"]["attn"]["wq"])
    assert np.array_equal(model.run0[1]["sub5"].attn.wq.detach().numpy(), wq[1])
    with pytest.raises(KeyError):
        from_jax_params(model, {**params, "extra": np.zeros(1)})


def test_slice_serves_like_reference():
    params, prompts, jlogits, jaux, jmeter, jtokens = reference_slice()
    _, tcfg = slice_cfgs()
    model = from_jax_params(LM(tcfg), jax.tree_util.tree_map(np.asarray, params))
    out = serve.serve_one_shot(model.requires_grad_(False),
                               torch.tensor(np.array(prompts)).long(), GEN,
                               log=lambda *_: None)
    close(out["logits"], jlogits, rtol=1e-4, atol=1e-4)
    aux = out["aux"]
    assert float(aux.n_blocks) == float(jaux.n_blocks) > 0
    assert np.array_equal(bits(aux.zero_frac), bits(jaux.zero_frac))
    assert 0.0 < float(aux.zero_frac) < 1.0
    assert aux.measured_bytes_exact() == jaux.measured_bytes_exact() > 0
    meter = out["meter"]
    assert [r.site for r in meter.records] == [r.site for r in jmeter.records]
    assert [(r.payload_bytes, r.index_bytes, r.dense_bytes, r.n_live) for r in meter.records] \
        == [(r.payload_bytes, r.index_bytes, r.dense_bytes, r.n_live) for r in jmeter.records]
    assert meter.measured_bytes() == jmeter.measured_bytes()
    assert out["reconcile"]["deltas"] == jmeter.reconcile()["deltas"]
    assert out["reconcile"]["n_sites"] == sum(r.compressed for r in meter.records) > 0
    assert np.array_equal(out["tokens"].numpy(), jtokens)


def test_serve_cli_runs_on_cpu(capsys):
    out = serve.main(["--arch", "gemma3-4b", "--reduced", "--backend", "fused",
                      "--device", "cpu", "--batch", "2", "--prompt-len", "32", "--gen", "3",
                      "--t-obj", "3.0"])
    text = capsys.readouterr().out
    assert "compressed KV-cache transport" in text and "lossless" in text
    assert tuple(out["tokens"].shape) == (2, 3) and out["reconcile"]["n_sites"] > 0
    checked = serve.main(["--arch", "gemma3-4b", "--reduced", "--backend", "fused",
                          "--device", "cpu", "--batch", "2", "--prompt-len", "32", "--gen",
                          "3", "--t-obj", "3.0", "--validate", "checksum"])
    assert "ingest validation (checksum): clean" in capsys.readouterr().out
    assert torch.equal(checked["tokens"], out["tokens"]) and checked["ingest_recovered"] == 0
    served = serve.main(["--reduced", "--device", "cpu", "--requests", "2", "--slots", "2",
                         "--prompt-len", "16", "--gen", "2"])      # continuous batching
    assert served["report"]["n_requests"] == 2
    argv = ["--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu", "--requests",
            "2", "--slots", "2", "--prompt-len", "16", "--gen", "2", "--t-obj", "0.025"]
    one = serve.main(argv)                                        # served sharded too
    tp = serve.main([*argv, "--model-parallel", "2"])
    assert tp["requests"] == {r.rid: (r.status, r.shed_reason, list(r.out))
                              for r in one["engine"].scheduler.completed}
    assert tp["report"]["kv_bytes_measured"] == one["report"]["kv_bytes_measured"] > 0


def test_forward_and_init_cache_match_reference():
    """``LM.forward`` (infer, fused) from the reference's weights: logits
    allclose, the sites' observables exact; ``init_cache`` has the
    reference's tree of shapes."""
    kw = dict(param_dtype="float32", compute_dtype="float32", zebra_backend="fused",
              zebra_t_obj=2.45)
    cfg = jconfigs.reduced("gemma3-4b").replace(**kw)
    tcfg = configs.reduced("gemma3-4b").replace(**kw)
    jmodel = JLM(cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1))
    tokens = lm_batch(LMDatasetConfig(vocab=cfg.vocab), 2, 64, 3)[:, :64]
    jlogits, jaux = jax.jit(lambda p, t: jmodel.forward(p, t, "infer"))(params,
                                                                       jnp.asarray(tokens))
    model = from_jax_params(LM(tcfg), jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(tokens).long(), "infer")
    close(logits, jlogits, rtol=1e-4, atol=1e-4)
    assert 0.0 < float(aux.zero_frac) < 1.0
    assert np.array_equal(bits(aux.zero_frac), bits(jaux.zero_frac))
    assert aux.measured_bytes_exact() == jaux.measured_bytes_exact() > 0
    _, scfg = slice_cfgs()
    shapes = lambda tree: [[{s: {n: tuple(t.shape) for n, t in kv.items()}
                             for s, kv in run.items()}] for run in tree]
    jcaches = JLM(slice_cfgs()[0]).init_cache(2, 256)
    assert shapes(LM(scfg).init_cache(2, 256)) == shapes(jcaches)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b", "gemma3-4b:ssm",
                                  "gemma3-4b:rglru"])
def test_unported_configs_raise(arch):
    """What the port does not run raises: the two recurrent architectures
    are registered now, and a name beside theirs is refused; their layer
    kinds build (here inside gemma3-4b's reduced config), and a kind outside
    the four is refused when the model is built."""
    if arch.startswith("gemma3-4b:"):
        kind = arch.split(":")[1]
        cfg = configs.reduced("gemma3-4b").replace(layer_pattern=(kind,), ssm_state=16,
                                                    ssm_head_dim=32)
        assert {t for *_, t, _ in LM(cfg)._layers()} == {kind}
        with pytest.raises(ValueError, match="layer type"):
            LM(cfg.replace(layer_pattern=(kind + "2",)))
    else:
        assert configs.get(arch).name == arch
        with pytest.raises(KeyError, match="unknown arch"):
            configs.get(arch + "-x")
