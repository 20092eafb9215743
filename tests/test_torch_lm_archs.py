"""The LM architectures the port adds beside gemma3-4b (``configs.ARCHS``:
command-r-35b, qwen2.5-14b, starcoder2-15b, chameleon-34b, whisper-medium,
llama4-scout-17b-a16e, granite-moe-1b-a400m, mamba2-2.7b,
recurrentgemma-2b) at their ``reduced()`` configs against the reference
package: the forward logits, and the serving slice (prefill, the
compressed cache handoff, greedy decode) on ``fused`` (mamba2: ``stream``,
the backend it is served on; its one site is ``layer_out``, which hands
the engine no weight) with its Zebra observables. Between them they
exercise layernorm with SwiGLU (command-r), the Q/K/V biases (qwen2.5,
starcoder2, whisper), the GELU MLP with its biases (starcoder2, whisper),
the untied vocabulary head (chameleon), the MoE FFN with its sites on the
dispatch buffer, in prefill and in decode (llama4, granite), whisper's
encoder and cross-attention, fed frames ~ N(0, 0.1²) from numpy, the SSD
block with its float32 state through the handoff (mamba2), and the RG-LRU
beside local attention (recurrentgemma).

The reference initialises the biases, the SSD's ``A_log``/``D``/
``dt_bias`` and the RG-LRU's ``b_a``/``b_x`` to constants, draws its own
head and its own Λ (``lam``), so every test draws those from numpy and
feeds the same values to both packages: a parameter that is dropped or
applied in the wrong place shows. Tolerances: everything runs in
float32; logits allclose at rtol/atol 1e-4 (the same products summed in
another order through two layers); bitmaps, byte counts, zero fractions,
the meter's records and the greedy tokens exact.
"""
import dataclasses
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
from repro.models.lm import LM as JLM
from repro.models.lm.ffn import ffn_apply as jffn_apply
from repro_torch import configs
from repro_torch.data import LMDatasetConfig, lm_batch
from repro_torch.launch import serve
from repro_torch.models.lm import LM
from repro_torch.models.lm.convert import from_jax_params
from repro_torch.models.lm.ffn import FFN, ffn_apply

from _torch_parity import bits

ARCHS = tuple(a for a in configs.ARCHS if a != "gemma3-4b")
# the fields each architecture brings, as the reference sets them
FIELDS = {"command-r-35b": dict(norm="layernorm", act="swiglu", qkv_bias=False,
                                tie_embeddings=True),
          "qwen2.5-14b": dict(norm="rmsnorm", act="swiglu", qkv_bias=True,
                              tie_embeddings=True),
          "starcoder2-15b": dict(norm="layernorm", act="gelu", qkv_bias=True,
                                 tie_embeddings=True),
          "chameleon-34b": dict(norm="rmsnorm", act="swiglu", qkv_bias=False,
                                tie_embeddings=False),
          "whisper-medium": dict(norm="layernorm", act="gelu", qkv_bias=True,
                                 tie_embeddings=True),
          "llama4-scout-17b-a16e": dict(norm="rmsnorm", act="swiglu", qkv_bias=False,
                                        tie_embeddings=True),
          "granite-moe-1b-a400m": dict(norm="rmsnorm", act="swiglu", qkv_bias=False,
                                       tie_embeddings=True),
          "mamba2-2.7b": dict(norm="rmsnorm", qkv_bias=False, tie_embeddings=True, d_ff=0,
                              layer_pattern=("ssm",), zebra_sites=("layer_out",)),
          "recurrentgemma-2b": dict(norm="rmsnorm", act="swiglu", qkv_bias=False,
                                    tie_embeddings=True,
                                    layer_pattern=("rglru", "rglru", "local"))}
# ffn_hidden T_obj of the reduced configs on these weights: zero fractions
# 0.26 (starcoder2) to 0.61 (command-r) in the forward at 2.5; the MoE
# experts are drawn with fan-in d·f, so their hidden maps are ~100x smaller;
# mamba2's layer_out map is the residual stream plus the SSD's output, whose
# 8 x 128 block maxima sit at 4.2-7.0 on these weights (zero fractions 0.5
# in the forward, 0.625 served at 4.8)
T_OBJ = 2.5
T_OBJS = {**dict.fromkeys(ARCHS, T_OBJ), "llama4-scout-17b-a16e": 0.025,
          "granite-moe-1b-a400m": 0.025, "mamba2-2.7b": 4.8}
# the served sites and backend: the kv_cache site on top of the
# architecture's own, as the server adds it
SITES = {a: ("ffn_hidden", "kv_cache") for a in ARCHS} | {"mamba2-2.7b": ("layer_out",
                                                                          "kv_cache")}
BACKEND = {a: "fused" for a in ARCHS} | {"mamba2-2.7b": "stream"}
B, S, GEN = 2, 64, 4
BIASES = ("bq", "bk", "bv", "b_up", "b_down", "b_a", "b_x")


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a.float() if isinstance(a, torch.Tensor) else a),
                               np.asarray(b, np.float32), **tol)


def cfgs(arch, **kw):
    kw = dict(param_dtype="float32", compute_dtype="float32", **kw)
    return jconfigs.reduced(arch).replace(**kw), configs.reduced(arch).replace(**kw)


def with_drawn_extras(params, seed: int):
    """The reference's params with every bias, the untied head, the SSD's
    ``A_log``/``D``/``dt_bias`` and the RG-LRU's ``lam`` replaced by numpy
    draws (the reference initialises them to constants / its own)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", None)
        normal = functools.partial(rng.normal, size=leaf.shape)
        if name in BIASES:
            return (normal() * 0.5).astype(np.float32)
        if name == "lm_head":
            return (normal() * leaf.shape[0] ** -0.5).astype(np.float32)
        if name in ("A_log", "dt_bias"):
            return (normal() * 0.5 - (name == "dt_bias")).astype(np.float32)
        if name == "D":
            return normal().astype(np.float32)
        if name == "lam":       # softplus^-1(-log(u) / 8), u ~ U(0.9, 0.999)
            u = rng.uniform(0.9, 0.999, size=leaf.shape)
            return np.log(np.expm1(-np.log(u) / 8.0)).astype(np.float32)
        return np.asarray(leaf)
    return jax.tree_util.tree_map_with_path(draw, params)


def enc_feats(arch, batch):
    """whisper's frames (batch, enc_seq, d) ~ N(0, 0.1²) from numpy (None for
    a decoder-only architecture)."""
    cfg = configs.reduced(arch)
    if not cfg.encoder_layers:
        return None
    rng = np.random.default_rng(7)
    return (rng.normal(size=(batch, cfg.enc_seq, cfg.d_model)) * 0.1).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@functools.lru_cache(maxsize=None)
def reference_params(arch):
    jcfg, _ = cfgs(arch)
    params = jax.jit(JLM(jcfg).init)(jax.random.PRNGKey(1))
    return with_drawn_extras(params, seed=len(arch))


def test_configs_match_reference():
    for arch in ARCHS:
        for get in ("get", "reduced"):
            mine, ref = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
            # zebra_backend's default is "reference" in the port, "" (its
            # alias) in the reference
            shared = ({f.name for f in dataclasses.fields(mine)}
                      & {f.name for f in dataclasses.fields(ref)}) - {"zebra_backend"}
            assert {k: getattr(mine, k) for k in shared} == {k: getattr(ref, k)
                                                            for k in shared}, (arch, get)
            assert {k: getattr(mine, k) for k in FIELDS[arch]} == FIELDS[arch]
        assert configs.get(arch).n_layers > 2 and arch in configs.ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_biases_and_head(arch):
    """``from_jax_params`` carries the biases and the head; the tree has
    exactly the reference's leaves."""
    params = reference_params(arch)
    _, tcfg = cfgs(arch)
    model = from_jax_params(LM(tcfg), params)
    names = set(model.state_dict())
    has_bias = FIELDS[arch]["qkv_bias"]
    moe, enc = tcfg.is_moe, tcfg.encoder_layers > 0
    first = tcfg.layer_pattern[0]
    ffn = first != "ssm" and not moe
    assert ("run0.0.sub0.attn.bq" in names) == (has_bias and first in ("global", "local"))
    assert ("run0.1.sub0.ffn.b_up" in names) == (FIELDS[arch].get("act") == "gelu")
    assert ("run0.0.sub0.ffn.w_gate" in names) == (ffn and FIELDS[arch]["act"] == "swiglu")
    assert ("run0.0.sub0.ssm.A_log" in names) == (first == "ssm")
    assert ("run0.0.sub0.rec.lam" in names) == ("run0.0.sub1.rec.b_x" in names) == (
        first == "rglru")
    assert ("run0.1.sub0.moe.router" in names) == moe
    assert ("run0.1.sub0.cross.wq" in names) == ("encoder.1.ffn.b_up" in names) == enc
    assert ("lm_head" in names) == (not FIELDS[arch]["tie_embeddings"])
    if moe:
        assert np.array_equal(model.run0[1]["sub0"].moe.w_down.detach().numpy(),
                              params["run0"]["sub0"]["moe"]["w_down"][1])
    if enc:
        got = model.encoder[1].attn.bq.detach().numpy()
        assert np.array_equal(got, params["encoder"]["attn"]["bq"][1]) and got.any()
    if first == "ssm":
        got = model.run0[1]["sub0"].ssm.dt_bias.detach().numpy()
        assert np.array_equal(got, params["run0"]["sub0"]["ssm"]["dt_bias"][1])
        assert not np.array_equal(got, np.full_like(got, -2.0))
    if first == "rglru":
        got = model.run0[0]["sub1"].rec.b_a.detach().numpy()
        assert np.array_equal(got, params["run0"]["sub1"]["rec"]["b_a"]) and got.any()
    if has_bias and first in ("global", "local"):
        got = model.run0[1]["sub0"].attn.bk.detach().numpy()
        assert np.array_equal(got, params["run0"]["sub0"]["attn"]["bk"][1]) and got.any()
    if "lm_head" in names:
        assert np.array_equal(model.lm_head.detach().numpy(), params["lm_head"])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """``LM.forward`` (infer, ``reference`` sites) from the same weights:
    logits allclose, the sites' zero fractions exact."""
    jcfg, tcfg = cfgs(arch, zebra_t_obj=T_OBJS[arch])
    params = reference_params(arch)
    tokens = lm_batch(LMDatasetConfig(vocab=jcfg.vocab), 2, 32, 3)[:, :32]
    ef = enc_feats(arch, 2)
    jlogits, jaux = jax.jit(lambda p, t, e: JLM(jcfg).forward(p, t, "infer", e))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(tokens), _j(ef))
    model = from_jax_params(LM(tcfg), params)
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(tokens).long(), "infer", _t(ef))
    close(logits, jlogits, rtol=1e-4, atol=1e-4)
    assert 0.0 < float(aux.zero_frac) < 1.0
    assert np.array_equal(bits(aux.zero_frac), bits(jaux.zero_frac))


@functools.lru_cache(maxsize=None)
def reference_slice(arch):
    """The reference server's one-shot path on the architecture's backend:
    prefill, pad, the compressed handoff metered per leaf, greedy tokens."""
    jcfg, _ = cfgs(arch, zebra_sites=SITES[arch], zebra_t_obj=T_OBJS[arch],
                   zebra_backend=BACKEND[arch])
    mesh = make_host_mesh(model=1)
    model = JLM(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, reference_params(arch))
    prompts = jnp.asarray(lm_batch(LMDatasetConfig(vocab=jcfg.vocab), B, S, 0)[:, :S])
    logits, (caches, enc), aux = jprefill_pad(jax.jit(make_prefill(model, mesh)), params,
                                             prompts, S + GEN, _j(enc_feats(arch, B)))
    meter = JMeter()
    ccaches = jcompress_tree(caches, bs=jcfg.zebra_block_seq, bc=jcfg.zebra_block_ch,
                             meter=meter, site="kv")
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    toks, _ = jax.jit(make_generate(model, mesh, GEN - 1))(params, tok, (ccaches, enc),
                                                           jnp.int32(S))
    tokens = np.concatenate([np.asarray(tok), np.asarray(toks)], 1)
    return np.asarray(prompts), np.asarray(logits), aux, meter, tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_slice_serves_like_reference(arch):
    """``serve.serve_one_shot`` on the architecture's backend: the prefill's
    last logits, the Zebra observables of every prefill site, the handoff's
    meter (mamba2: its float32 SSD state and conv buffers) and the greedy
    tokens of prefill + decode."""
    prompts, jlogits, jaux, jmeter, jtokens = reference_slice(arch)
    _, tcfg = cfgs(arch, zebra_sites=SITES[arch], zebra_t_obj=T_OBJS[arch],
                   zebra_backend=BACKEND[arch])
    model = from_jax_params(LM(tcfg), reference_params(arch)).requires_grad_(False)
    out = serve.serve_one_shot(model, torch.from_numpy(prompts.copy()).long(), GEN,
                               log=lambda *_: None, enc_feats=_t(enc_feats(arch, B)))
    close(out["logits"], jlogits, rtol=1e-4, atol=1e-4)
    aux = out["aux"]
    assert float(aux.n_blocks) == float(jaux.n_blocks) > 0
    assert np.array_equal(bits(aux.zero_frac), bits(jaux.zero_frac))
    assert 0.0 < float(aux.zero_frac) < 1.0
    # an MoE site hands the engine no weight: fused runs the masking pass
    # there, which moves no stream bytes
    assert aux.measured_bytes_exact() == jaux.measured_bytes_exact()
    assert (aux.measured_bytes_exact() > 0) == (not tcfg.is_moe)
    meter = out["meter"]
    assert [(r.site, r.payload_bytes, r.index_bytes, r.dense_bytes, r.n_live)
            for r in meter.records] == [(r.site, r.payload_bytes, r.index_bytes,
                                         r.dense_bytes, r.n_live) for r in jmeter.records]
    assert out["reconcile"]["n_sites"] == sum(r.compressed for r in meter.records) > 0
    assert np.array_equal(out["tokens"].numpy(), jtokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--reduced", "--backend", BACKEND[arch], "--device", "cpu",
                      "--batch", "2", "--prompt-len", "32", "--gen", "3", "--t-obj",
                      str(T_OBJS[arch])])
    assert "compressed KV-cache transport" in capsys.readouterr().out
    assert tuple(out["tokens"].shape) == (2, 3) and out["reconcile"]["n_sites"] > 0
    assert out["model"].cfg.param_dtype == "bfloat16"
    one = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--layers", "1",
                      "--batch", "1", "--prompt-len", "16", "--gen", "2"])
    assert one["model"].cfg.n_layers == 1 and len(list(one["model"]._layers())) == 1


def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation and torch's
    ``F.gelu`` to the erf form; the GELU MLP follows the reference (rtol
    1e-5 in float32), where the erf form is ~7e-4 away."""
    jcfg, tcfg = cfgs("starcoder2-15b", zebra_enabled=False)
    params = reference_params("starcoder2-15b")["run0"]["sub0"]["ffn"]
    p = {k: v[0] for k, v in params.items() if k != "zebra_tnet"}
    ffn = FFN(tcfg)
    ffn.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in p.items()})
    x = np.random.default_rng(0).normal(size=(2, 8, tcfg.d_model)).astype(np.float32) * 2
    with torch.no_grad():
        y, _ = ffn_apply(ffn, torch.from_numpy(x), tcfg, "infer")
        erf = (torch.nn.functional.gelu(torch.from_numpy(x) @ ffn.w_up + ffn.b_up)
               @ ffn.w_down + ffn.b_down)
    jy, _ = jffn_apply(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), jcfg, "infer")
    close(y, jy, rtol=1e-5, atol=1e-5)
    assert np.abs(erf.numpy() - np.asarray(jy)).max() > 1e-4
    z = torch.linspace(-4, 4, 101)
    close(torch.nn.functional.gelu(z, approximate="tanh"), jax.nn.gelu(jnp.asarray(z.numpy())),
          rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layers", [-1, 3])
def test_serve_refuses_layers_outside_the_depth(layers):
    """``--layers`` keeps the first N layers: a negative count, or one past
    the architecture's depth (the reduced configs have 2), is refused."""
    assert configs.reduced("qwen2.5-14b").n_layers == 2
    with pytest.raises(ValueError, match="n_layers"):
        serve.main(["--arch", "qwen2.5-14b", "--reduced", "--device", "cpu", "--layers",
                    str(layers), "--batch", "1", "--prompt-len", "16", "--gen", "2"])


def test_serve_one_shot_backend_override():
    """``serve_one_shot(backend=...)`` serves one call on another backend
    with the same weights and leaves the model's own config as it was:
    the tokens equal a fresh ``reference`` model's of the same seed."""
    argv = ["--arch", "starcoder2-15b", "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "16", "--gen", "3", "--t-obj", str(T_OBJ)]
    fused = serve.main([*argv, "--backend", "fused"])
    ref = serve.main([*argv, "--backend", "reference"])
    model, own = fused["model"], fused["model"].cfg
    out = serve.serve_one_shot(model, fused["prompts"], 3, backend="reference",
                               log=lambda *_: None)
    assert model.cfg is own and own.zebra_backend == "fused"
    assert out["meter"] is None and out["aux"] == ref["aux"]
    assert torch.equal(out["tokens"], ref["tokens"])
    assert torch.equal(out["logits"], ref["logits"])
