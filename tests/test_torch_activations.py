"""bf16 rounding of the LM path against the reference package.

``models.lm.ffn.silu``/``gelu`` in bf16 take the reference's ops one by
one, each rounded to bf16, and equal ``jax.jit(jax.nn.silu/gelu)`` bit for
bit, apart from one case: XLA's CPU flushes subnormal results to zero and
the port (like the card) does not. At |x| ~ 88, silu's factor
``1 / (1 + exp(-x))`` is a bf16 subnormal; XLA makes it 0 and the product
-0.0, the port keeps a tiny normal product. In float32 both are
``F.silu``/``F.gelu`` as before (the op-by-op form differs from those in
the last bit there).

The bf16 reduced gemma3-4b: the ``ffn_hidden`` bitmaps, ``zero_frac`` and
the stream bytes follow the maps exactly (given the reference's own maps,
the port's sites give its bitmaps, zero fraction and bytes bit for bit),
and the maps themselves differ where a float32 sum is ordered otherwise:
the bf16 projections' accumulation (torch's bf16 GEMM against XLA's dot)
and XLA's float32 cos/sin/exp. Those flip 3 of the 384 blocks, each a
block whose maximum sits within one bf16 step of T_obj on either side.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.configs as jconfigs
import repro.models.lm.ffn as jffn
from repro.models.lm import LM as JLM
from repro_torch import configs
from repro_torch.core.zebra import ZebraConfig
from repro_torch.core.engine import zebra_site
from repro_torch.data import LMDatasetConfig, lm_batch
from repro_torch.models.lm import LM
from repro_torch.models.lm import ffn
from repro_torch.models.lm.convert import from_jax_params

from _torch_parity import bits, jax_lm_params, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

N = 65536
T_OBJ = 2.45
BS, BC = 8, 128


def _draws(scale):
    return (np.random.default_rng(0).normal(size=N) * scale).astype(np.float32)


def _flushed(x: torch.Tensor) -> torch.Tensor:
    """Elements whose silu factor 1 / (1 + exp(-x)) is a bf16 subnormal."""
    one = torch.ones((), dtype=x.dtype)
    f = (one / (one + torch.exp(-x))).float()
    return (f != 0) & (f.abs() < torch.finfo(torch.float32).tiny)


@pytest.mark.parametrize("scale", [0.05, 3.0, 30.0])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_bf16_activation_matches_reference(act, scale):
    x = _draws(scale)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = getattr(ffn, act)(xt)
    want = jax.jit(getattr(jax.nn, act))(jnp.asarray(x).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    differ = bits(got) != bits(want)
    flushed = _flushed(xt).numpy() if act == "silu" else np.zeros(N, bool)
    assert not (differ & ~flushed).any(), np.nonzero(differ & ~flushed)[0][:8]
    # where XLA flushed the factor, its product is a zero of x's sign; the
    # port's is x times the subnormal, finite and tiny
    w = np.asarray(jnp.asarray(want, jnp.float32))[flushed]
    assert (w == 0).all() and (np.signbit(w) == np.signbit(x[flushed])).all()
    g = got.float().numpy()[flushed]
    assert np.isfinite(g).all() and (np.abs(g) < 1e-30).all()
    assert flushed.sum() == (27 if scale == 30.0 and act == "silu" else 0)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_float32_activation_unchanged(act):
    """In float32 the port keeps F.silu and the tanh F.gelu, bit for bit."""
    xt = torch.from_numpy(_draws(3.0))
    want = F.silu(xt) if act == "silu" else F.gelu(xt, approximate="tanh")
    assert torch.equal(getattr(ffn, act)(xt).view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# The bf16 reduced gemma3-4b
# ---------------------------------------------------------------------------

def _capture(mod, key, store):
    """Wrap ``mod.zebra_site`` to record each ``ffn_hidden`` input map and
    the site's aux."""
    inner = mod.zebra_site

    def site(x, cfg, **kw):
        y, aux = inner(x, cfg, **kw)
        store.setdefault(key, []).append((x, aux))
        return y, aux
    return inner, site


def _blockmax(x) -> torch.Tensor:
    x = x.float() if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(jnp.asarray(x, jnp.float32)))
    return x.reshape(-1, BS, x.shape[-1] // BC, BC).abs().amax(dim=(1, 3))


@pytest.mark.parametrize("backend", ["reference", "stream"])
def test_bf16_lm_bitmaps_match_reference(backend, monkeypatch):
    """One bf16 forward (``LM.loss`` in train mode, the metrics a train
    step reports) of the 6-layer reduced gemma3-4b at T_obj 2.45 on the
    reference (jitted, ``remat="none"`` so the maps can leave the trace)
    and the port, per ``ffn_hidden`` site."""
    kw = dict(compute_dtype="bfloat16", zebra_t_obj=T_OBJ, zebra_tnet=False,
              ce_chunk=64, zebra_backend=backend)
    jcfg = jconfigs.reduced("gemma3-4b").replace(remat="none", **kw)
    tcfg = configs.reduced("gemma3-4b").replace(**kw)
    jm = JLM(jcfg)
    params = jax_lm_params(jcfg)
    tokens = lm_batch(LMDatasetConfig(vocab=jcfg.vocab), 2, 128, 0)
    store = {}
    inner, site = _capture(jffn, "j", store)
    monkeypatch.setattr(jffn, "zebra_site", site)

    def loss(p, t):
        store["j"] = []
        _, m = jm.loss(p, t, "train")
        return m, [x for x, _ in store["j"]]
    jmet, jmaps = jax.jit(loss)(params, jnp.asarray(tokens))
    monkeypatch.setattr(jffn, "zebra_site", inner)

    model = from_jax_params(LM(tcfg), jax.tree_util.tree_map(np.asarray, params))
    tinner, tsite = _capture(ffn, "t", store)
    monkeypatch.setattr(ffn, "zebra_site", tsite)
    with torch.no_grad():
        _, m = model.loss(torch.from_numpy(tokens).long())
    monkeypatch.setattr(ffn, "zebra_site", tinner)
    sites = store["t"]
    assert len(sites) == len(jmaps) == 6
    assert {a.backend for _, a in sites} == {backend}

    t_bf16 = float(torch.tensor(T_OBJ, dtype=torch.bfloat16))
    step = 2.0 ** -6                           # one bf16 step at 2 <= |x| < 4
    n_blocks, flips, live_t, live_j = 0, [], 0, 0
    zc = ZebraConfig(t_obj=T_OBJ, block_seq=BS, block_ch=BC, mode="train",
                     backend=backend, use_tnet=False)
    for i, ((x, aux), xj) in enumerate(zip(sites, jmaps)):
        keep_t, keep_j = _blockmax(x) >= t_bf16, _blockmax(xj) >= t_bf16
        # the port's site on the reference's own map: its bitmap, zero
        # fraction and bytes bit for bit
        xr = torch.from_numpy(np.array(jnp.asarray(xj, jnp.float32))).to(torch.bfloat16)
        with torch.no_grad():
            yr, ar = zebra_site(xr, zc, site="ffn_hidden")
        assert torch.equal(yr != 0, torch.repeat_interleave(torch.repeat_interleave(
            keep_j.reshape(2, -1, keep_j.shape[-1]), BS, 1), BC, 2) & (xr != 0)), i
        assert math.isclose(float(ar.zero_frac), 1 - int(keep_j.sum()) / keep_j.numel(),
                            abs_tol=2 ** -24), i
        assert math.isclose(float(aux.zero_frac), 1 - int(keep_t.sum()) / keep_t.numel(),
                            abs_tol=2 ** -24), i
        n_blocks += keep_t.numel()
        live_t, live_j = live_t + int(keep_t.sum()), live_j + int(keep_j.sum())
        mt, mj = _blockmax(x), _blockmax(xj)
        for idx in torch.nonzero(keep_t != keep_j):
            a, b = float(mt[tuple(idx)]), float(mj[tuple(idx)])
            assert min(a, b) < t_bf16 <= max(a, b), (i, idx, a, b)
            assert max(abs(a - t_bf16), abs(b - t_bf16)) <= step, (i, idx, a, b)
            flips.append(i)
    # the flips named in the module docstring: layers 2, 4 and 5, one block each
    assert flips == [2, 4, 5]
    assert n_blocks == 384
    zf_t = float(m["zero_frac"])
    zf_j = float(jmet["zero_frac"])
    assert math.isclose(zf_t, 1 - live_t / n_blocks, abs_tol=1e-6)
    assert math.isclose(zf_j, 1 - live_j / n_blocks, abs_tol=1e-6)
    if backend == "stream":
        nbytes = int(float(jmet["measured_bytes_hi"])) * 2 ** 24 + int(
            float(jmet["measured_bytes_lo"]))
        per_block = BS * BC * 2
        assert int(m["measured_bytes"]) - nbytes == (live_t - live_j) * per_block
        assert int(m["measured_bytes"]) == sum(int(a.measured_bytes) for _, a in sites)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_bf16_activation_gradient_is_torchs(act):
    """The op-by-op bf16 forward keeps torch's backward (float32 inside,
    one rounding), the gradients the port trained with before."""
    x = torch.from_numpy(_draws(3.0)[:4096]).to(torch.bfloat16).requires_grad_()
    g = torch.from_numpy(_draws(1.0)[:4096]).to(torch.bfloat16)
    (got,) = torch.autograd.grad(getattr(ffn, act)(x), x, g)
    ref = F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")
    (want,) = torch.autograd.grad(ref, x, g)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
