"""``attend_local_scanned`` (``LMConfig.local_impl = "scanned"``): the
sliding window one chunk at a time, each chunk under
``torch.utils.checkpoint`` when gradients are on. Against the reference's
``attend_local_scanned`` (rtol/atol 1e-6, float32) and the port's banded
``attend_local``: bit for bit in float32 and bf16 on these shapes (the
same ops on the same chunk, batched over one chunk instead of all), and
their gradients bit for bit too. A reduced gemma3-4b loss and its
gradients with ``local_impl="scanned"`` equal ``"banded"``'s."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm.attention import attend_local_scanned as jscanned
from repro_torch import configs
from repro_torch.data import LMDatasetConfig, lm_batch
from repro_torch.launch import steps
from repro_torch.models.lm import LM
from repro_torch.models.lm import attention as attn

from _torch_parity import bits, one_thread  # noqa: F401


def qkv(seed, dtype=torch.float32, B=2, S=64, Hq=4, Hkv=2, hd=16):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, S, h, hd)).astype(np.float32) for h in (Hq, Hkv, Hkv)]
    return arrs, [torch.from_numpy(a).to(dtype) for a in arrs]


@pytest.mark.parametrize("window", [16, 64])
def test_scanned_matches_reference(window):
    arrs, ts = qkv(window)
    got = attn.attend_local_scanned(*ts, window=window)
    want = jscanned(*(jnp.asarray(a) for a in arrs), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scanned_equals_banded_with_gradients(dtype, one_thread):  # noqa: F811
    _, ts = qkv(1, getattr(torch, dtype))
    outs = []
    for fn in (attn.attend_local, attn.attend_local_scanned):
        q, k, v = (t.clone().requires_grad_(True) for t in ts)
        o = fn(q, k, v, window=16)
        (o.float() ** 2).sum().backward()
        outs.append([o, q.grad, k.grad, v.grad])
    for a, b in zip(*outs):
        assert np.array_equal(bits(a), bits(b))


def test_scanned_checkpoints_each_chunk(monkeypatch):
    """With gradients on, one checkpoint per chunk; without, none."""
    calls = []
    inner = attn.checkpoint
    monkeypatch.setattr(attn, "checkpoint", lambda *a, **k: calls.append(1) or inner(*a, **k))
    _, ts = qkv(2)
    q = ts[0].requires_grad_(True)
    attn.attend_local_scanned(q, *ts[1:], window=16)
    assert len(calls) == 64 // 16
    calls.clear()
    with torch.no_grad():
        attn.attend_local_scanned(*ts, window=16)
    assert calls == []


def test_scanned_model_loss_equals_banded(one_thread):  # noqa: F811
    """The reduced gemma3-4b (window 32, sequence 128: the local layers take
    the window path) trains the same bits with either local form."""
    cfg = configs.reduced("gemma3-4b").replace(vocab=512, compute_dtype="float32",
                                               zebra_t_obj=2.45, zebra_tnet=False)
    tokens = torch.from_numpy(lm_batch(LMDatasetConfig(vocab=512), 2, 128, 0)).long()
    runs = {}
    for impl in ("banded", "scanned"):
        model = LM(cfg.replace(local_impl=impl), generator=torch.Generator().manual_seed(0))
        runs[impl] = steps.accumulate_gradients(model, dict(model.named_parameters()), tokens)
    (g0, l0, m0), (g1, l1, m1) = runs["banded"], runs["scanned"]
    assert np.array_equal(bits(l0), bits(l1))
    assert np.array_equal(bits(m0["zero_frac"]), bits(m1["zero_frac"]))
    assert all(np.array_equal(bits(g0[k]), bits(g1[k])) for k in g0)
