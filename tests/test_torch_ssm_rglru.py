"""Mamba-2's SSD block and Griffin's RG-LRU in the port against the
reference package (``repro.models.lm.{ssm,rglru}``), on the reference's
own parameters with numpy-drawn inputs, and the reference's own checks
(``tests/test_ssm_rglru.py``: naive sequential recurrences, decode ==
full sequence, prefill state == decode state) run against the port.

The reference initialises ``A_log``, ``D``, ``dt_bias``, ``b_a`` and
``b_x`` to constants, so the tests draw them from numpy: a misplaced one
would not show otherwise. Tolerances:

* the RG-LRU's linear scan against ``jax.lax.associative_scan``: bit for
  bit in float32 (the same odd-even recursion, each ``ar·bl + br`` fused as
  XLA's CPU fuses it);
* the SSD in float32: rtol/atol 1e-5 (the reference's ``cumsum`` lowers to
  a ``reduce_window`` whose order of summation the port does not follow,
  and its small matmuls sum in another order: ~3e-6 seen); the RG-LRU in
  float32: 1e-5 (``sigmoid``, ``softplus`` and the matmuls round
  differently: ~2e-7 seen);
* bf16 at the served rounding (bf16 weights and activations, the float32
  parameters kept): rtol/atol 2e-2, a few bf16 steps of outputs of
  magnitude ~1 (a bf16 matmul sums in another order; 7.8e-3 seen); the
  reduced models in bf16 compute: the Zebra zero fraction bit for bit (no
  block flips) and logits within a bf16 step (0.0625 at ~12);
* gradients against ``jax.grad``: rtol/atol 1e-4;
* the naive recurrences and the decode/prefill consistency: the
  reference's own 2e-3 (float32 chunked against sequential), and the
  whole model's prefill + decode against its forward at 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models.lm import LM as JLM
from repro.models.lm import rglru as JR
from repro.models.lm import ssm as JS
from repro.models.lm.config import LMConfig as JLMConfig
from repro_torch import configs
from repro_torch.data import LMDatasetConfig, lm_batch
from repro_torch.models.lm import LM, LMConfig
from repro_torch.models.lm.convert import from_jax_params
from repro_torch.models.lm import rglru as R
from repro_torch.models.lm import ssm as S
from repro_torch.models.layers import rmsnorm_apply

from _torch_parity import bits

SSM_KW = dict(name="t", d_model=32, n_layers=1, layer_pattern=("ssm",), d_ff=0, vocab=64,
              ssm_state=8, ssm_head_dim=8, ssm_expand=2, ssm_chunk=32, head_dim=8,
              zebra_enabled=False)
RG_KW = dict(name="t", d_model=32, n_layers=1, layer_pattern=("rglru",), d_ff=64, vocab=64,
             lru_dim=32, zebra_enabled=False)
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
GRAD = dict(rtol=1e-4, atol=1e-4)


def close(a, b, **tol):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), **tol)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def port_module(cls, kw, params, dtype=torch.float32):
    """The port's block holding the reference's parameters (the float32
    ones stay float32, as the reference keeps them)."""
    m = cls(LMConfig(**kw), dtype=dtype)
    with torch.no_grad():
        for k, t in m.state_dict().items():
            t.copy_(torch.from_numpy(np.array(params[k], np.float32)).to(t.dtype))
    return m


def _draw(rng, shape, scale=1.0, shift=0.0):
    return jnp.asarray(rng.normal(size=shape) * scale + shift, jnp.float32)


@functools.lru_cache(maxsize=None)
def ssm_params(seed: int = 0):
    """The reference's SSD parameters, ``A_log``/``D``/``dt_bias`` from numpy."""
    cfg = JLMConfig(**SSM_KW)
    p = JS.ssm_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    rng = np.random.default_rng(seed)
    nh = cfg.ssm_heads
    return dict(p, A_log=_draw(rng, nh, 0.5), D=_draw(rng, nh),
                dt_bias=_draw(rng, nh, 0.5, -1.0))


@functools.lru_cache(maxsize=None)
def rg_params(seed: int = 0):
    """The reference's RG-LRU parameters, ``b_a``/``b_x`` from numpy."""
    p = JR.rglru_init(jax.random.PRNGKey(seed), JLMConfig(**RG_KW), jnp.float32)
    rng = np.random.default_rng(seed)
    return dict(p, b_a=_draw(rng, 32, 0.5), b_x=_draw(rng, 32, 0.5))


def inputs(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape) * 0.5).astype(np.float32)


def to_dtype(tree, dtype):
    """The served tree: bf16 weights, the reference's float32 leaves kept."""
    keep = {"A_log", "D", "dt_bias", "b_a", "b_x", "lam", "scale"}
    return jax.tree_util.tree_map_with_path(
        lambda path, v: v if path[-1].key in keep else v.astype(dtype), params_dict(tree))


def params_dict(p):
    return {k: params_dict(v) if isinstance(v, dict) else v for k, v in p.items()}


# ---------------------------------------------------------------------------
# The RG-LRU scan, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 7, 255, 2048])
def test_linear_scan_equals_associative_scan(n):
    """``rglru.linear_scan`` against the reference's ``associative_scan``
    with its combine, jitted, on (2, n, 256) float32 (odd and even lengths
    take the recursion's two fill-in forms)."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.0, 1.0, size=(2, n, 256)).astype(np.float32)
    b = rng.normal(size=(2, n, 256)).astype(np.float32)

    def combine(l, r):
        al, bl = l
        ar, br = r
        return al * ar, ar * bl + br
    want = jax.jit(lambda a, b: jax.lax.associative_scan(combine, (a, b), axis=1)[1])(a, b)
    got = R.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(bits(got), bits(want))


# ---------------------------------------------------------------------------
# The blocks against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_apply_matches_reference(dtype):
    """``ssm_apply`` at S 64 with chunks of 32 (the inter-chunk scan runs):
    float32 at 1e-5, bf16 at the served rounding."""
    jcfg, tcfg = JLMConfig(**SSM_KW), LMConfig(**SSM_KW)
    jp = to_dtype(ssm_params(), getattr(jnp, dtype))
    m = port_module(S.SSM, SSM_KW, flat(jp), getattr(torch, dtype))
    x = inputs((2, 64, 32), 1)
    want = jax.jit(lambda p, x: JS.ssm_apply(p, x, jcfg))(jp, jnp.asarray(x).astype(dtype))
    with torch.no_grad():
        got = S.ssm_apply(m, torch.from_numpy(x).to(getattr(torch, dtype)), tcfg)
    assert got.dtype == getattr(torch, dtype)
    close(got, np.asarray(want.astype(jnp.float32)), **(F32 if dtype == "float32" else BF16))


def test_ssm_prefill_state_and_decode_step_match_reference():
    """``ssm_prefill_state`` (H from one einsum over the sequence, the conv
    buffers) and one ``ssm_decode_step`` from that state: outputs and the
    new state."""
    jcfg, tcfg = JLMConfig(**SSM_KW), LMConfig(**SSM_KW)
    jp = ssm_params()
    m = port_module(S.SSM, SSM_KW, flat(jp))
    x, x1 = inputs((2, 48, 32), 2), inputs((2, 1, 32), 3)
    jstate = jax.jit(lambda p, x: JS.ssm_prefill_state(p, x, jcfg))(jp, x)
    jy, jnew = jax.jit(lambda p, x, c: JS.ssm_decode_step(p, x, c, jcfg))(jp, x1, jstate)
    with torch.no_grad():
        state = S.ssm_prefill_state(m, torch.from_numpy(x), tcfg)
        y, new = S.ssm_decode_step(m, torch.from_numpy(x1), state, tcfg)
    assert state["H"].dtype == torch.float32 and state.keys() == jstate.keys()
    for k in jstate:
        close(state[k], jstate[k], **F32)
        close(new[k], jnew[k], **F32)
    close(y, jy, **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_apply_matches_reference(dtype):
    jcfg, tcfg = JLMConfig(**RG_KW), LMConfig(**RG_KW)
    jp = to_dtype(rg_params(), getattr(jnp, dtype))
    m = port_module(R.RGLRU, RG_KW, flat(jp), getattr(torch, dtype))
    x = inputs((2, 64, 32), 4)
    want = jax.jit(lambda p, x: JR.rglru_apply(p, x, jcfg))(jp, jnp.asarray(x).astype(dtype))
    with torch.no_grad():
        got = R.rglru_apply(m, torch.from_numpy(x).to(getattr(torch, dtype)), tcfg)
    close(got, np.asarray(want.astype(jnp.float32)), **(F32 if dtype == "float32" else BF16))


def test_rglru_decode_step_matches_reference():
    """One ``rglru_decode_step`` from a drawn state: output, ``h`` and the
    conv buffer (a shift of the inputs: bit for bit)."""
    jcfg, tcfg = JLMConfig(**RG_KW), LMConfig(**RG_KW)
    jp = rg_params()
    m = port_module(R.RGLRU, RG_KW, flat(jp))
    x1 = inputs((2, 1, 32), 5)
    cache = {"h": inputs((2, 32), 6), "conv": inputs((2, 3, 32), 7)}
    jy, jnew = jax.jit(lambda p, x, c: JR.rglru_decode_step(p, x, c, jcfg))(jp, x1, cache)
    with torch.no_grad():
        y, new = R.rglru_decode_step(m, torch.from_numpy(x1),
                                     {k: torch.from_numpy(v) for k, v in cache.items()}, tcfg)
    close(y, jy, **F32)
    close(new["h"], jnew["h"], **F32)
    assert np.array_equal(bits(new["conv"]), bits(jnew["conv"]))


@pytest.mark.parametrize("block", ["ssm", "rglru"])
def test_grads_match_reference(block):
    """The gradient of Σ y·g with respect to every parameter and the input,
    against ``jax.grad`` of the reference's block (float32)."""
    kw, cls, jmod, params = ((SSM_KW, S.SSM, JS.ssm_apply, ssm_params()) if block == "ssm"
                             else (RG_KW, R.RGLRU, JR.rglru_apply, rg_params()))
    jcfg, tcfg = JLMConfig(**kw), LMConfig(**kw)
    x, g = inputs((2, 64, 32), 8), inputs((2, 64, 32), 9)
    jgp, jgx = jax.jit(jax.grad(lambda p, x: jnp.sum(jmod(p, x, jcfg) * g), argnums=(0, 1)))(
        params, jnp.asarray(x))
    m = port_module(cls, kw, flat(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    apply = S.ssm_apply if block == "ssm" else R.rglru_apply
    (apply(m, xt, tcfg) * torch.from_numpy(g)).sum().backward()
    close(xt.grad, jgx, **GRAD)
    want = flat(jgp)
    assert set(want) == {k for k, _ in m.named_parameters()}
    for k, prm in m.named_parameters():
        close(prm.grad, want[k], **GRAD, err_msg=k)


# ---------------------------------------------------------------------------
# The reference's own checks (tests/test_ssm_rglru.py), against the port
# ---------------------------------------------------------------------------

def naive_ssd(m: S.SSM, x: torch.Tensor, cfg: LMConfig) -> np.ndarray:
    """Sequential: h_t = h_{t-1}·exp(dt·A) + dt·B·x; y = C·h + D·x, float64."""
    B, Sq, _ = x.shape
    di, ds, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xr, Bm, Cm, dt = S._projections(m, x)
    xs = S._conv_silu(xr, m.conv_x).reshape(B, Sq, nh, hd).double().numpy()
    Bn = S._conv_silu(Bm, m.conv_b).double().numpy()
    Cn = S._conv_silu(Cm, m.conv_c).double().numpy()
    A = -np.exp(m.A_log.double().numpy())
    dtv = np.log1p(np.exp(dt.double().numpy() + m.dt_bias.double().numpy()))
    H = np.zeros((B, nh, ds, hd))
    ys = np.zeros((B, Sq, nh, hd))
    for t in range(Sq):
        H = H * np.exp(dtv[:, t] * A)[..., None, None] + np.einsum(
            "bs,bh,bhp->bhsp", Bn[:, t], dtv[:, t], xs[:, t])
        ys[:, t] = np.einsum("bs,bhsp->bhp", Cn[:, t], H) + m.D.double().numpy()[:, None] * xs[:, t]
    y = ys.reshape(B, Sq, di) * torch.nn.functional.silu(z).double().numpy()
    y = rmsnorm_apply(m.out_norm.scale, torch.from_numpy(y).float())
    return (y @ m.out_proj).numpy()


def naive_rglru(m: R.RGLRU, x: torch.Tensor) -> np.ndarray:
    gate = torch.nn.functional.gelu(x @ m.w_gate_branch, approximate="tanh")
    a, b = R._gates(m, S.causal_conv1d(x @ m.w_rec_branch, m.conv_w))
    a, b = a.double().numpy(), b.double().numpy()
    h, hs = np.zeros_like(a[:, 0]), np.zeros_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs[:, t] = h
    return ((torch.from_numpy(hs).float() * gate) @ m.w_out).numpy()


REF_TOL = dict(rtol=2e-3, atol=2e-3)


@torch.no_grad()
def test_ssd_chunked_matches_naive():
    cfg = LMConfig(**dict(SSM_KW, ssm_chunk=8))
    m = port_module(S.SSM, SSM_KW, flat(ssm_params(1)))
    x = torch.from_numpy(inputs((2, 32, 32), 10))
    close(S.ssm_apply(m, x, cfg), naive_ssd(m, x, cfg), **REF_TOL)


@torch.no_grad()
def test_ssd_decode_matches_full():
    cfg = LMConfig(**dict(SSM_KW, ssm_chunk=8))
    m = port_module(S.SSM, SSM_KW, flat(ssm_params(1)))
    x = torch.from_numpy(inputs((1, 16, 32), 11))
    cache, outs = S.ssm_init_cache(cfg, 1, torch.float32), []
    for t in range(16):
        y, cache = S.ssm_decode_step(m, x[:, t:t + 1], cache, cfg)
        outs.append(y)
    close(torch.cat(outs, 1), S.ssm_apply(m, x, cfg), **REF_TOL)


@torch.no_grad()
def test_ssd_prefill_state_matches_decode_state():
    cfg = LMConfig(**dict(SSM_KW, ssm_chunk=8))
    m = port_module(S.SSM, SSM_KW, flat(ssm_params(1)))
    x = torch.from_numpy(inputs((1, 24, 32), 12))
    st = S.ssm_prefill_state(m, x, cfg)
    cache = S.ssm_init_cache(cfg, 1, torch.float32)
    for t in range(24):
        _, cache = S.ssm_decode_step(m, x[:, t:t + 1], cache, cfg)
    close(st["H"], cache["H"], **REF_TOL)
    for k in ("conv_x", "conv_b", "conv_c"):       # a whole-sequence matmul vs one a token
        close(st[k], cache[k], rtol=1e-5, atol=1e-6)


@torch.no_grad()
def test_rglru_scan_matches_naive():
    m = port_module(R.RGLRU, RG_KW, flat(rg_params(1)))
    x = torch.from_numpy(inputs((2, 20, 32), 13))
    close(R.rglru_apply(m, x, LMConfig(**RG_KW)), naive_rglru(m, x), **REF_TOL)


@torch.no_grad()
def test_rglru_decode_matches_full():
    cfg = LMConfig(**RG_KW)
    m = port_module(R.RGLRU, RG_KW, flat(rg_params(1)))
    x = torch.from_numpy(inputs((1, 12, 32), 14))
    cache, outs = R.rglru_init_cache(cfg, 1, torch.float32), []
    for t in range(12):
        y, cache = R.rglru_decode_step(m, x[:, t:t + 1], cache, cfg)
        outs.append(y)
    close(torch.cat(outs, 1), R.rglru_apply(m, x, cfg), **REF_TOL)
    _, st = R.rglru_prefill(m, x, cfg)
    close(st["h"], cache["h"], **REF_TOL)
    close(st["conv"], cache["conv"], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The whole model: prefill + decode == forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["mamba2-2.7b", "recurrentgemma-2b", "recurrentgemma-2b:6"])
@torch.no_grad()
def test_prefill_decode_matches_forward(case):
    """``tests/test_lm_archs.py``'s check on the port: prefill(t[:32]) and
    greedy-free decode steps reproduce forward(t) at every position
    (float32, Zebra off). mamba2's 2 layers are one stacked run;
    recurrentgemma at 6 layers stacks 2 superlayers, so a stacked RG-LRU
    state is decoded and written back into its slice (without the write
    back, decode would run on the prefill's state)."""
    arch, _, layers = case.partition(":")
    cfg = configs.reduced(arch).replace(zebra_enabled=False, compute_dtype="float32",
                                        n_layers=int(layers or configs.reduced(arch).n_layers))
    model = LM(cfg, generator=torch.Generator().manual_seed(0))
    assert any(count > 1 for _, count in model.runs) == (case != "recurrentgemma-2b")
    B, Sq, S0 = 1, 64, 32
    toks = torch.from_numpy(lm_batch(LMDatasetConfig(vocab=cfg.vocab), B, Sq, 3)[:, :Sq]).long()
    full, _ = model(toks, "infer")
    logits0, (caches, enc), _ = model.prefill(toks[:, :S0], cache_len=Sq)
    close(logits0, full[:, S0 - 1].numpy(), rtol=1e-4, atol=1e-4)
    state = (caches, enc)
    for t in range(S0, Sq):
        logits_t, state = model.decode_step(toks[:, t:t + 1], state, t)
        close(logits_t, full[:, t].numpy(), rtol=1e-4, atol=1e-4)


def test_init_cache_has_the_reference_tree():
    """``LM.init_cache``: the reference's leaves, shapes and dtypes (the
    recurrent states float32, the conv buffers and K/V in bf16), stacked
    over each run's repeats."""
    for arch in ("mamba2-2.7b", "recurrentgemma-2b"):
        want = JLM(jconfigs.reduced(arch).replace(n_layers=6)).init_cache(2, 64)
        got = LM(configs.reduced(arch).replace(n_layers=6)).init_cache(2, 64)
        assert len(got) == len(want)
        for run, jrun in zip(got, want):
            assert {(s, n): (tuple(t.shape), str(t.dtype)[6:]) for s, kv in run.items()
                    for n, t in kv.items()} == {(s, n): (t.shape, str(t.dtype))
                                                for s, kv in jrun.items()
                                                for n, t in kv.items()}


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b"])
def test_bf16_forward_blocks_match_reference(arch):
    """The reduced models in bf16 compute (float32 parameters, as trained)
    from the same drawn weights (``test_torch_lm_archs.reference_params``):
    the Zebra sites' zero fraction bit for bit, so no bf16 block flips on
    these maps (mamba2: 10 of 16 ``layer_out`` blocks dead in both,
    recurrentgemma the same count of ``ffn_hidden`` blocks in both), and
    the logits within a bf16 step of values up to ~12 (0.0625 seen)."""
    from test_torch_lm_archs import T_OBJS, reference_params
    kw = dict(param_dtype="float32", compute_dtype="bfloat16", zebra_t_obj=T_OBJS[arch])
    jcfg, tcfg = jconfigs.reduced(arch).replace(**kw), configs.reduced(arch).replace(**kw)
    params = reference_params(arch)
    tokens = lm_batch(LMDatasetConfig(vocab=jcfg.vocab), 2, 64, 3)[:, :64]
    jlogits, jaux = jax.jit(lambda p, t: JLM(jcfg).forward(p, t, "infer"))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(tokens))
    model = from_jax_params(LM(tcfg), params)
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(tokens).long(), "infer")
    assert 0.0 < float(aux.zero_frac) < 1.0
    assert np.array_equal(bits(aux.zero_frac), bits(jaux.zero_frac))
    close(logits, np.asarray(jlogits.astype(jnp.float32)), rtol=1e-2, atol=0.0625)
