"""The port's step supervisor (``repro_torch.ft.StepSupervisor``), after the
reference's ``tests/test_ft_supervisor.py``: crash, restore and resume;
resume from disk; straggler detection; the heartbeat. Then the port's own
case, a train step that updates the model's tensors in place: a poison
batch must leave every parameter and moment bit-identical, and a 3-layer
reduced gemma3-4b run crashed after a dirtying step and resumed from its
checkpoint must equal the uninterrupted run bit for bit (parameters, both
AdamW moments, the step and the loader's step)."""
import gc
import json
import threading
import weakref

import numpy as np
import pytest
import torch

from repro_torch import configs, optim
from repro_torch.ft import FTConfig, StepSupervisor, TransientStep, crashing_step
from repro_torch.launch import steps, train
from repro_torch.models.lm import LM

from _torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


class FlakyStep:
    """Fails once at a chosen step, then recovers (a preempted device)."""

    def __init__(self, fail_at):
        self.fail_at = fail_at
        self.calls = 0

    def __call__(self, state, batch):
        self.calls += 1
        step = int(state["step"])
        if step == self.fail_at and self.calls == self.fail_at + 1:
            raise RuntimeError("simulated preemption: device failure")
        new = {"w": state["w"] + batch.mean(), "step": state["step"] + 1}
        return new, {"loss": torch.tensor(1.0 / (step + 1))}


class CountingIter:
    def __init__(self):
        self.i = 0

    def __next__(self):
        self.i += 1
        return torch.full((4,), float(self.i))

    def restore(self, step):
        self.i = int(step)


def test_crash_restore_resume(tmp_path):
    sup = StepSupervisor(FTConfig(ckpt_dir=str(tmp_path), ckpt_every=3, max_failures=2))
    state = {"w": torch.tensor(0.0), "step": torch.tensor(0, dtype=torch.int32)}
    it = CountingIter()
    final, step = sup.run(state, FlakyStep(fail_at=5), it, steps=10,
                          loader_state_fn=lambda: it.i)
    assert step == 10 and sup.failures == 1
    assert sup.ckpt.latest_step() == 10
    assert [e["policy"] for e in sup.failure_log] == ["restore-retry"]
    # the loader went back to the checkpoint's step, so w sums batches 1..10
    assert float(final["w"]) == sum(range(1, 11))


def test_resume_or_init_from_disk(tmp_path):
    sup = StepSupervisor(FTConfig(ckpt_dir=str(tmp_path), ckpt_every=2))
    sup.ckpt.save(4, {"w": torch.tensor(7.0), "step": 4}, {"loader_step": 4})
    sup.ckpt.wait()
    like = {"w": torch.tensor(0.0), "step": 0}
    restored, step, extra = sup.resume_or_init(lambda: like)
    assert step == 4 and extra["loader_step"] == 4
    assert restored["w"] is like["w"] and float(like["w"]) == 7.0 and restored["step"] == 4


def test_no_ckpt_dir_starts_fresh_and_reraises(tmp_path):
    sup = StepSupervisor(FTConfig())
    assert sup.ckpt is None and sup.resume_or_init(lambda: {"w": 1})[1:] == (0, {})
    with pytest.raises(RuntimeError, match="preemption"):
        sup.run({"w": torch.tensor(0.0), "step": torch.tensor(0)}, FlakyStep(fail_at=1),
                CountingIter(), steps=3)


def test_straggler_detection(tmp_path):
    sup = StepSupervisor(FTConfig(ckpt_dir=str(tmp_path), straggler_window=10,
                                  straggler_zscore=3.0))
    rng = np.random.default_rng(0)
    for _ in range(10):
        assert not sup.check_straggler(0.10 + rng.random() * 1e-3)
    assert sup.check_straggler(5.0)          # 50x the mean -> flagged
    assert len(sup.straggler_events) == 1


def test_heartbeat_written(tmp_path):
    sup = StepSupervisor(FTConfig(ckpt_dir=str(tmp_path)))
    sup.heartbeat(12, {"loss": torch.tensor(0.5)})
    hb = json.load(open(sup.hb_path))
    assert hb["step"] == 12 and hb["host"] == 0 and hb["metrics"]["loss"] == 0.5


# ---------------------------------------------------------------------------
# The LM train step under the supervisor
# ---------------------------------------------------------------------------

CFG = configs.reduced("gemma3-4b").replace(vocab=512, n_layers=3, zebra_tnet=False,
                                           zebra_t_obj=2.45, zebra_backend="stream")


def _snapshot(state):
    return {**{f"p/{k}": v.clone() for k, v in state["params"].items()},
            **{f"{s}/{k}": v.clone() for s in ("m", "v") for k, v in state["opt"][s].items()}}


def _same(a, b):
    return [k for k in a if not torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))]


def test_poison_batch_leaves_state_untouched():
    """A non-finite loss raises ``PoisonBatch`` before compression and the
    optimizer touch anything; the supervisor skips the batch and counts
    the step."""
    model = LM(CFG, generator=torch.Generator().manual_seed(0))
    opt = optim.adamw(optim.constant(1e-3))
    state = steps.init_train_state(model, opt)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 33))).long()
    steps.train_step(model, opt, state, {"tokens": tokens}, check_finite=True)
    before = _snapshot(state)
    with torch.no_grad():
        model.final_norm.scale[0] = float("nan")
        poisoned = model.final_norm.scale.clone()
    before["p/final_norm.scale"] = poisoned
    sup = StepSupervisor(FTConfig())

    def step_fn(state, batch):
        state, m = steps.train_step(model, opt, state, batch, check_finite=True)
        return state, {"loss": m["loss"]}
    out, step = sup.run(state, step_fn, iter([{"tokens": tokens}]), steps=1, start_step=0)
    assert step == 1 and len(sup.skipped_batches) == 1
    assert [e["policy"] for e in sup.failure_log] == ["skip-batch"]
    assert out["step"] == 1 and not _same(_snapshot(out), before)
    assert all(p.grad is None for p in model.parameters())


def _run(ckpt, crash_at=None, exc=TransientStep):
    model = LM(CFG, generator=torch.Generator().manual_seed(0))
    inner = train.train_step

    def dirty():
        """The crash after a half-applied update: every parameter moved."""
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
        return exc("injected crash")
    if crash_at is not None:
        train.train_step = crashing_step(lambda *a, **k: inner(*a, **k), crash_at, exc=dirty)
    try:
        return train.train_lm(CFG, steps=4, batch=2, seq=32, device="cpu", model=model,
                              ckpt=ckpt, ckpt_every=2, log=lambda *_: None)
    finally:
        train.train_step = inner


@pytest.fixture
def uninterrupted(one_thread):
    return _run(None)


def test_crashed_run_resumes_bit_for_bit(tmp_path, uninterrupted):
    _, want, hist_w, _ = uninterrupted
    _, got, hist, sup = _run(str(tmp_path), crash_at=3)
    assert [e["class"] for e in sup.failure_log] == ["TransientStep"]
    assert sup.ckpt.all_steps() == [2, 4]
    assert got["step"] == want["step"] == 4
    assert not _same(_snapshot(got), _snapshot(want))
    assert [h["loss"] for h in hist] == [h["loss"] for h in hist_w]
    assert json.load(open(tmp_path / "step_4" / "manifest.json"))["extra"] == {
        "loader_step": 4}


def test_run_started_again_continues_from_disk(tmp_path, uninterrupted):
    """A run stopped after step 2 by an error that is no fault, then the
    same command again: the second run resumes at step 2 (state and
    loader) and ends where the uninterrupted run did."""
    _, want, _, _ = uninterrupted
    with pytest.raises(KeyboardInterrupt):
        _run(str(tmp_path), crash_at=3, exc=KeyboardInterrupt)
    for t in threading.enumerate():          # the step-2 write, still in flight
        if t.name.startswith("ckpt-writer"):
            t.join()
    model = LM(CFG, generator=torch.Generator().manual_seed(1))       # other weights
    _, got, hist, _ = train.train_lm(CFG, steps=4, batch=2, seq=32, device="cpu",
                                     model=model, ckpt=str(tmp_path), ckpt_every=2,
                                     log=lambda *_: None)
    assert [h["step"] for h in hist] == [3, 4]
    assert not _same(_snapshot(got), _snapshot(want))


def test_a_crashed_run_holds_nothing_once_dropped(tmp_path):
    """A run crashed, restored and finished keeps its tensors in no reference
    cycle: dropped, the model's and the optimizer's go with their last
    reference, the collector off for the whole run."""
    gc.disable()
    try:
        model, state, _, sup = _run(str(tmp_path), crash_at=3)
        assert [e["class"] for e in sup.failure_log] == ["TransientStep"]
        gone = [weakref.ref(model.final_norm.scale),
                weakref.ref(state["opt"]["m"]["final_norm.scale"])]
        del model, state, sup
        assert [r() for r in gone] == [None, None]
    finally:
        gc.enable()
