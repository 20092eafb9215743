"""The port's checkpoint manager (``repro_torch.checkpoint``) against the
reference's contract and format: round trip into the model's own tensors,
``keep_last``, async and atomic publish, the CRC fallback chain, an
explicit step that never falls back, CRC32s equal to the reference's on
the same leaves, and compressed activation maps whose stored arrays equal
the reference's byte for byte (the ``BENCH_faults.json`` rows
``detect.ckpt.bitflip`` and ``detect.ckpt.acts_bitflip`` at CPU size)."""
import gc
import json
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import manager as jmanager
from repro.models.lm import LM as JLM
from repro_torch import configs, optim
from repro_torch.checkpoint import (CheckpointManager, load_compressed_acts,
                                    save_compressed_acts)
from repro_torch.ft import CorruptStream, corrupt_file
from repro_torch.launch import steps
from repro_torch.models.lm import LM
from repro_torch.models.lm.convert import from_jax_params, port_params

from _torch_parity import bits


def _tree(s: float):
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3) * s,
            "n": {"b": torch.ones(4, dtype=torch.bfloat16) * s}, "step": int(s)}


def test_checkpoint_roundtrip_and_keep_last(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, async_save=False)
    for s in (10, 20, 30):
        mgr.save(s, _tree(s), extra={"loader_step": s})
    assert mgr.all_steps() == [20, 30]
    like = _tree(0)
    a, b = like["a"], like["n"]["b"]
    step, restored, extra = mgr.restore(like)
    assert step == 30 and extra["loader_step"] == 30 and restored["step"] == 30
    # into the same tensors, each in its own dtype (bf16 stored as float32)
    assert restored["a"] is a and restored["n"]["b"] is b
    assert torch.equal(a, torch.arange(6, dtype=torch.float32).reshape(2, 3) * 30)
    assert b.dtype == torch.bfloat16 and torch.equal(b, torch.full((4,), 30.0,
                                                                   dtype=torch.bfloat16))


def test_checkpoint_async_and_atomicity(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=3, async_save=True)
    w = torch.ones(8, 8)
    mgr.save(1, {"w": w})
    w.mul_(5.0)             # the step overwrites its tensors while the write runs
    mgr.wait()
    assert mgr.latest_step() == 1
    assert not [d for d in os.listdir(tmp_path) if d.startswith("tmp.")]
    like = {"w": torch.zeros(8, 8)}
    mgr.restore(like)
    assert torch.equal(like["w"], torch.ones(8, 8))      # the copy taken at save


def test_checkpoint_write_failure_surfaces(tmp_path, monkeypatch):
    """A failed background write raises at the next ``wait``, not never."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    monkeypatch.setattr(np, "savez", lambda *a, **k: (_ for _ in ()).throw(OSError("disk")))
    mgr.save(1, {"w": torch.ones(2)})
    with pytest.raises(OSError, match="disk"):
        mgr.wait()
    assert mgr.latest_step() is None


def _save_steps(ckpt, steps_):
    state = None
    for s in steps_:
        state = {"w": torch.full((16, 16), float(s)), "s": torch.tensor(s, dtype=torch.int32)}
        ckpt.save(s, state, {"loader_step": s})
    ckpt.wait()
    return state


def test_ckpt_corrupt_newest_falls_back(tmp_path):
    """``detect.ckpt.bitflip``: injected 1, detected 1, recovered 1
    (restore-older)."""
    ckpt = CheckpointManager(str(tmp_path), keep_last=3)
    like = _save_steps(ckpt, [2, 4, 6])
    corrupt_file(os.path.join(str(tmp_path), "step_6", "shard_0.npz"))
    with pytest.raises(CorruptStream, match="step_6"):
        ckpt.verify(6)
    step, tree, extra = ckpt.restore(like)
    assert step == 4 and extra["loader_step"] == 4
    assert float(tree["w"][0, 0]) == 4.0 and int(tree["s"]) == 4


def test_ckpt_fallback_leaves_no_cycle_holding_the_state(tmp_path):
    """A restore that fell back holds nothing of ``like`` once it returns:
    its tensors go with their last reference, the collector off (a kept
    failure's traceback would hold the restore's frame, and so ``like``)."""
    ckpt = CheckpointManager(str(tmp_path), keep_last=3)
    like = _save_steps(ckpt, [2, 4, 6])
    corrupt_file(os.path.join(str(tmp_path), "step_6", "shard_0.npz"))
    gone = weakref.ref(like["w"])
    gc.disable()
    try:
        assert ckpt.restore(like)[0] == 4
        del like
        assert gone() is None
    finally:
        gc.enable()


def test_ckpt_explicit_step_never_falls_back(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep_last=3)
    like = _save_steps(ckpt, [2, 4])
    corrupt_file(os.path.join(str(tmp_path), "step_4", "shard_0.npz"))
    with pytest.raises(CorruptStream, match="CRC mismatch|unreadable"):
        ckpt.restore(like, step=4)


def test_ckpt_whole_chain_corrupt_raises(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep_last=3)
    like = _save_steps(ckpt, [2, 4])
    for s in (2, 4):
        corrupt_file(os.path.join(str(tmp_path), f"step_{s}", "shard_0.npz"))
    with pytest.raises(CorruptStream, match="no restorable checkpoint"):
        ckpt.restore(like)


def test_crc32_equals_reference(tmp_path):
    """The reduced gemma3-4b's parameters: each float32 leaf's CRC32 in the
    port's manifest equals the reference's ``_crc`` of the same array (the
    reference's paths mapped to the port's names by ``convert``), and the
    two managers' manifests hold the same CRCs."""
    jcfg = jconfigs.reduced("gemma3-4b").replace(vocab=512)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(JLM(jcfg).init)(jax.random.PRNGKey(0)))
    model = from_jax_params(LM(configs.reduced("gemma3-4b").replace(vocab=512)), params)
    state = steps.init_train_state(model, optim.adamw(optim.constant(1e-3)))
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(3, state)
    JCheckpointManager(str(tmp_path / "ref"), async_save=False).save(
        3, {"params": jax.tree_util.tree_map(jnp.asarray, params)})
    port = json.load(open(tmp_path / "port" / "step_3" / "manifest.json"))
    ref = json.load(open(tmp_path / "ref" / "step_3" / "manifest.json"))
    want = {f"params/{k}": jmanager._crc(v) for k, v in port_params(model, params).items()}
    got = {k: v for k, v in port["checksums"].items() if k.startswith("params/")}
    assert got == want
    assert sorted(got.values()) == sorted(ref["checksums"].values())
    assert {k.split("/")[0] for k in port["paths"]} == {"params", "opt", "step"}
    assert set(port["paths"]) == set(port["checksums"])


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "whisper-medium"])
def test_moe_and_encoder_leaves_roundtrip_with_reference_crcs(arch, tmp_path):
    """The MoE's leaves (the float32 router, the bf16 expert stacks) and
    whisper's (the unstacked encoder, ``enc_norm``, cross-attention) in a
    bf16 model: each parameter's CRC32 equals the reference's ``_crc`` of
    the same array as the reference stores it, the router stays float32,
    and a restore into a fresh model gives every tensor
    back bit for bit, each in its own dtype."""
    kw = dict(vocab=512, param_dtype="bfloat16")
    jcfg = jconfigs.reduced(arch).replace(**kw)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(JLM(jcfg).init)(jax.random.PRNGKey(0)))
    model = from_jax_params(LM(configs.reduced(arch).replace(**kw)), params)
    state = steps.init_train_state(model, optim.adamw(optim.constant(1e-3)), "none")
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, state)
    man = json.load(open(tmp_path / "step_5" / "manifest.json"))
    src = port_params(model, params)
    dtypes = {k: str(t.dtype).split(".")[-1] for k, t in model.state_dict().items()}
    # each leaf as the port holds it, flattened and CRC'd by the reference's
    # manager (which stores a bf16 leaf as float32, as npz has no bf16)
    want = {f"params/{k}": jmanager._crc(jmanager._flatten(
        {"x": jnp.asarray(v).astype(dtypes[k])})["x"]) for k, v in src.items()}
    got = {k: man["checksums"][k] for k in want}
    assert got == want
    names = set(src)
    if arch.startswith("granite"):
        assert "params/run0.1.sub0.moe.router" in want
        assert model.run0[1]["sub0"].moe.router.dtype == torch.float32
    else:
        assert {"encoder.1.attn.wq", "enc_norm.scale", "run0.0.sub0.cross.wo"} <= names
    fresh = LM(configs.reduced(arch).replace(**kw), generator=torch.Generator().manual_seed(9))
    like = steps.init_train_state(fresh, optim.adamw(optim.constant(1e-3)), "none")
    step, restored, _ = mgr.restore(like)
    assert step == 5
    for k, v in model.state_dict().items():
        got_t = fresh.state_dict()[k]
        assert got_t.dtype == v.dtype and np.array_equal(bits(got_t), bits(v)), k


def _acts(seed=0):
    """An NCHW float32 map (4x4 spatial blocks), a bf16 and a float16 token
    map (8x128 blocks), each with dead blocks, and a map neither layout
    divides (stored dense)."""
    rng = np.random.default_rng(seed)
    nchw = rng.normal(size=(2, 3, 8, 8)).astype(np.float32)
    nchw[:, 1, :4, 4:] = 0.0
    tok = rng.normal(size=(2, 16, 256)).astype(np.float32)
    tok[:, :8, :128] = 0.0
    tok16 = tok[:, :, :128] * (rng.random((2, 16, 1)) > 0.5)
    odd = rng.normal(size=(3, 5)).astype(np.float32)
    return {"cnn/site3": nchw, "ffn_hidden": tok, "kv": tok16.astype(np.float16),
            "odd": odd}


def test_compressed_acts_arrays_equal_reference(tmp_path):
    acts = _acts()
    ref_acts = dict(acts, ffn_hidden=jnp.asarray(acts["ffn_hidden"]).astype(jnp.bfloat16))
    port_acts = {k: torch.from_numpy(v) for k, v in acts.items()}
    port_acts["ffn_hidden"] = port_acts["ffn_hidden"].to(torch.bfloat16)
    jstats = jmanager.save_compressed_acts(str(tmp_path / "ref.npz"),
                                           {k: np.asarray(v) for k, v in ref_acts.items()})
    stats = save_compressed_acts(str(tmp_path / "port.npz"), port_acts)
    assert stats == jstats
    ref, port = np.load(tmp_path / "ref.npz"), np.load(tmp_path / "port.npz")
    assert set(ref.files) == set(port.files)
    for k in ref.files:
        a, b = ref[k], port[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    for name in ("cnn/site3", "ffn_hidden", "kv"):
        assert stats[name]["stored_bytes"] < stats[name]["dense_bytes"], name
    assert stats["odd"]["stored_bytes"] == stats["odd"]["dense_bytes"]


def test_restore_acts_roundtrip_and_flipped_index(tmp_path):
    """``save_acts`` then ``restore_acts``: every map back bit for bit; a
    flipped index bit on disk raises ``CorruptStream`` naming the map
    (``detect.ckpt.acts_bitflip``, reject-named-invariant)."""
    ckpt = CheckpointManager(str(tmp_path))
    acts = {k: torch.from_numpy(v) for k, v in _acts(1).items()}
    acts["ffn_hidden"] = acts["ffn_hidden"].to(torch.bfloat16)
    stats = ckpt.save_acts(1, acts)
    out = ckpt.restore_acts(1)
    for k, v in acts.items():
        assert out[k].dtype == v.dtype and np.array_equal(bits(out[k]), bits(v)), k
    payload, index = "ffn_hidden/payload", "ffn_hidden/index"
    with np.load(tmp_path / "acts_1.npz") as f:
        data = dict(f.items())
    assert stats["ffn_hidden"]["stored_bytes"] == data[payload].nbytes + data[index].nbytes
    data[index] = data[index].copy()
    data[index][0] ^= 1
    np.savez(tmp_path / "acts_1.npz", **data)
    with pytest.raises(CorruptStream, match="ckpt-acts:ffn_hidden"):
        ckpt.restore_acts(1)
    assert set(load_compressed_acts(str(tmp_path / "acts_1.npz"))) == set(acts)
