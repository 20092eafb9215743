"""The port's MoE FFN (``repro_torch.models.lm.ffn.moe_apply``) against the
reference's ``moe_apply`` on the same numpy weights, at the reduced
granite-moe-1b-a400m (d 128, 8 experts, top-2, d_ff 128) and the reduced
llama4-scout-17b-a16e (4 experts, top-1).

Exact: the expert choice, each pair's slot (``dest`` in expert order,
``slot_of`` in token order), the capacity, the ``ffn_hidden`` site's
bitmap, zero fraction, block count and stream bytes, on ``reference`` and
on ``stream``. The reference does not return its dispatch, so
:func:`reference_dispatch` repeats its routing lines in ``jnp`` under
``jax.jit``. allclose: y (float32 at rtol/atol 1e-5; bf16 within two bf16
steps, ``Y16``) and ``router_aux`` (rtol 1e-6). The gradients to the
experts and the router equal the reference's at rtol 1e-4 / atol 1e-6
(float32), and two CPU backward passes of one MoE step are bit for bit
equal, with one thread and with the machine's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.lm.ffn as jffn
from repro_torch import configs
from repro_torch.models.lm import ffn

from _torch_parity import bits, one_thread  # noqa: F401

# T_obj where the filled slots' hidden blocks of these draws are partly
# dead (the empty slots are zero rows, dead at any T_obj > 0)
T_OBJ = 0.025
B, S = 2, 32
Y16 = dict(rtol=2 ** -7, atol=1e-4)
ARCHS = ("granite-moe-1b-a400m", "llama4-scout-17b-a16e")


def cfgs(arch=ARCHS[0], **kw):
    kw = dict(zebra_tnet=False, zebra_t_obj=T_OBJ, **kw)
    return jconfigs.reduced(arch).replace(**kw), configs.reduced(arch).replace(**kw)


def draw(jcfg, seed=0):
    """The reference's ``moe_init`` draw as float32 numpy."""
    p = jffn.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


def both(p, x, tcfg, dtype: str):
    """The reference's parameters and input in ``dtype`` (the router stays
    float32, as the reference keeps it) and the port's MoE and input, the
    same values."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v) if k == "router" else jnp.asarray(v).astype(jdt)
          for k, v in p.items()}
    m = ffn.MoE(tcfg, dtype=tdt)
    m.load_state_dict({k: torch.from_numpy(v.copy()).to(torch.float32 if k == "router"
                                                         else tdt) for k, v in p.items()})
    return jp, jnp.asarray(x).astype(jdt), m, torch.from_numpy(x.copy()).to(tdt)


def inputs(d, seed=1, zero_rows=()):
    x = np.random.default_rng(seed).normal(size=(B, S, d)).astype(np.float32)
    for b, s in zero_rows:
        x[b, s] = 0.0
    return x


def reference_dispatch(jp, jx, cfg):
    """The reference ``moe_apply``'s routing lines, jitted: (expert_idx,
    dest, slot_of, cap)."""
    T = jx.shape[0] * jx.shape[1]
    E, k = cfg.n_experts, cfg.top_k
    cap = int(max(1, round(cfg.capacity_factor * T * k / E)))

    def f(router, x):
        probs = jax.nn.softmax(x.reshape(T, -1).astype(jnp.float32) @ router, axis=-1)
        _, expert_idx = jax.lax.top_k(probs, k)
        flat_e = expert_idx.reshape(-1)
        order = jnp.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        first = jnp.searchsorted(sorted_e, sorted_e, side="left")
        rank = jnp.arange(T * k) - first
        dest = jnp.where(rank < cap, sorted_e * cap + rank, E * cap)
        slot_of = jnp.zeros((T * k,), jnp.int32).at[order].set(dest.astype(jnp.int32))
        return expert_idx, dest, slot_of
    return (*(np.asarray(a) for a in jax.jit(f)(jp["router"], jx)), cap)


def run_reference(jp, jx, cfg, monkeypatch):
    """Jitted reference ``moe_apply`` in infer mode: (y, zero_frac, stream
    bytes, router_aux, the site's masked hidden map)."""
    seen = []
    inner = jffn.zebra_site

    def site(h, zc, **kw):
        y, aux = inner(h, zc, **kw)
        seen.append(y)
        return y, aux
    with monkeypatch.context() as mp:
        mp.setattr(jffn, "zebra_site", site)

        def f(p, x):
            seen.clear()
            y, zaux, raux = jffn.moe_apply(p, x, cfg, "infer")
            return y, zaux.zero_frac, zaux.measured_bytes, raux, seen[0]
        return jax.jit(f)(jp, jx)


def run_port(m, x, cfg, monkeypatch):
    """Port ``moe_apply`` in infer mode: (y, SiteAux, router_aux, masked
    hidden map, Routing)."""
    seen, routes = [], []
    inner_site, inner_route = ffn.zebra_site, ffn.moe_route
    with monkeypatch.context() as mp:
        mp.setattr(ffn, "zebra_site", lambda h, zc, **kw: seen.append(
            inner_site(h, zc, **kw)) or seen[-1])
        mp.setattr(ffn, "moe_route", lambda *a: routes.append(inner_route(*a)) or routes[-1])
        with torch.no_grad():
            y, zaux, raux = ffn.moe_apply(m, x, cfg, "infer")
    return y, zaux, raux, seen[0][0], routes[0]


def block_bitmap(h, bs=8, bc=128) -> np.ndarray:
    """Keep bitmap of a masked (1, M, K) hidden map: a live block holds a
    nonzero value (its max is >= T_obj > 0), a dead one none."""
    h = h.float().numpy() if isinstance(h, torch.Tensor) else np.asarray(h, np.float32)
    M, K = h.shape[-2:]
    return np.abs(h.reshape(M // bs, bs, K // bc, bc)).max(axis=(1, 3)) > 0


@pytest.mark.parametrize("backend", ["reference", "stream"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_reference(arch, dtype, backend, monkeypatch):
    jcfg, tcfg = cfgs(arch, zebra_backend=backend)
    jp, jx, m, x = both(draw(jcfg), inputs(jcfg.d_model), tcfg, dtype)
    jy, jzf, jmb, jraux, jh = run_reference(jp, jx, jcfg, monkeypatch)
    eidx, dest, slot_of, cap = reference_dispatch(jp, jx, jcfg)
    y, zaux, raux, h, r = run_port(m, x, tcfg, monkeypatch)
    assert r.cap == cap and np.array_equal(r.expert_idx.numpy(), eidx)
    assert np.array_equal(r.dest.numpy(), dest) and np.array_equal(r.slot_of.numpy(), slot_of)
    assert zaux.backend == backend
    assert np.array_equal(block_bitmap(h), block_bitmap(jh))
    assert np.array_equal(bits(zaux.zero_frac), bits(jzf))
    assert 0.3 < float(zaux.zero_frac) < 0.95
    assert int(zaux.n_blocks) == (tcfg.n_experts * cap // 8) * (tcfg.d_ff // 128)
    assert int(zaux.measured_bytes) == int(jmb) and (int(jmb) > 0) == (backend == "stream")
    np.testing.assert_allclose(float(raux), float(jraux), rtol=1e-6)
    assert raux.dtype == torch.float32 and m.router.dtype == torch.float32
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else Y16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32), **tol)


def test_capacity_drops(monkeypatch):
    """``capacity_factor`` 0.25: pairs past their expert's capacity go to
    the overflow slot (dest E·cap) exactly as in the reference, and their
    tokens get only their kept choices (a token with none gets 0)."""
    jcfg, tcfg = cfgs(capacity_factor=0.25)
    jp, jx, m, x = both(draw(jcfg), inputs(jcfg.d_model, seed=2), tcfg, "float32")
    eidx, dest, slot_of, cap = reference_dispatch(jp, jx, jcfg)
    jy, *_ = run_reference(jp, jx, jcfg, monkeypatch)
    y, _, _, _, r = run_port(m, x, tcfg, monkeypatch)
    E = tcfg.n_experts
    assert cap == 4 and (dest == E * cap).sum() > 0
    assert np.array_equal(r.dest.numpy(), dest) and np.array_equal(r.slot_of.numpy(), slot_of)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    dropped = (slot_of.reshape(-1, tcfg.top_k) == E * cap).all(axis=1).reshape(B, S)
    assert dropped.any() and not y.numpy()[dropped].any()


def test_ties_take_the_lower_expert(monkeypatch):
    """A zero input row has exactly uniform probabilities: ``jax.lax.top_k``
    keeps the lower expert indices, and so does the port's stable
    descending sort (``torch.topk`` picks others, shown here)."""
    jcfg, tcfg = cfgs()
    zero = [(0, 3), (1, 0), (1, 31)]
    jp, jx, m, x = both(draw(jcfg), inputs(jcfg.d_model, zero_rows=zero), tcfg, "float32")
    eidx, dest, slot_of, _ = reference_dispatch(jp, jx, jcfg)
    _, _, _, _, r = run_port(m, x, tcfg, monkeypatch)
    rows = [b * S + s for b, s in zero]
    assert np.array_equal(eidx[rows], np.tile(np.arange(tcfg.top_k), (3, 1)))
    assert np.array_equal(r.expert_idx.numpy(), eidx)
    assert np.array_equal(r.dest.numpy(), dest)
    uniform = torch.full((1, tcfg.n_experts), 1.0 / tcfg.n_experts)
    assert torch.topk(uniform, tcfg.top_k).indices.tolist() != [list(range(tcfg.top_k))]


def _port_loss(m, x, cfg):
    y, _, raux = ffn.moe_apply(m, x, cfg, "train")
    return (y ** 2).sum() + 0.01 * raux


def test_gradients_match_reference():
    """Gradients of ``sum(y²) + 0.01·router_aux`` (train mode, constant
    T_obj on ``reference``) to the router and the three expert stacks."""
    jcfg, tcfg = cfgs()
    jp, jx, m, x = both(draw(jcfg), inputs(jcfg.d_model, seed=3), tcfg, "float32")

    def loss(p):
        y, _, raux = jffn.moe_apply(p, jx, jcfg, "train")
        return jnp.sum(y ** 2) + 0.01 * raux
    jg = jax.jit(jax.grad(loss))(jp)
    _port_loss(m, x, tcfg).backward()
    for k in ("router", "w_gate", "w_up", "w_down"):
        g = getattr(m, k).grad
        assert float(g.abs().sum()) > 0, k
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("threads", ["one", "all"])
def test_backward_is_deterministic(threads, request):
    """Two backward passes of one MoE step give the same gradients bit for
    bit (to the input too: a token's k copies add in one reduction, no
    index with repeated rows), at bf16 on ``stream``, with one CPU thread
    and with the machine's."""
    if threads == "one":
        request.getfixturevalue("one_thread")
    _, tcfg = cfgs(zebra_backend="stream", top_k=4)
    jcfg, _ = cfgs()
    grads = []
    for _ in range(2):
        _, _, m, x = both(draw(jcfg), inputs(tcfg.d_model, seed=4), tcfg, "bfloat16")
        x.requires_grad_(True)
        _port_loss(m, x, tcfg).backward()
        grads.append([x.grad] + [p.grad for p in m.parameters()])
    assert all(np.array_equal(bits(a), bits(b)) for a, b in zip(*grads))
    assert float(grads[0][0].float().abs().sum()) > 0
