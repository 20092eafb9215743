"""Fault-tolerance supervisor of the training loop (``repro.ft.supervisor``).

Wraps a step loop with:

* periodic checkpointing (async, atomic) and resume from the newest valid
  checkpoint;
* a heartbeat file that external watchdogs read;
* straggler detection: the step time's z-score over a trailing window;
* the failure policy shared with a serving loop (:class:`FailurePolicy`):
  classify, log, count, back off, forgive after a run of successes.

The port's train step updates the model's tensors in place, so "keep the
state" means the step must not touch it: a supervised step raises
``PoisonBatch`` on a non-finite loss before the optimizer runs
(``launch.steps.train_step(check_finite=True)``), and a restore copies the
checkpoint into the same tensors (``CheckpointManager.restore``).

Under a joined world (the train state of a model cut for training, given
as ``StepSupervisor(cfg, model=...)``) the checkpoints hold whole leaves
(``checkpoint.sharded``): rank 0 alone writes them and the heartbeat,
every rank restores its shards of them. A fault is recovered when every
rank raises it at the same call (as a failing step looks to the
reference's one controller) or the all-reduced loss is not finite; a
fault on one rank only leaves the others inside the step's collectives.

:func:`remesh_state` is the reference's elastic re-mesh: the model axis
halved until it fits the live world, the state and its module re-cut
from whole leaves by the checkpoint restore's re-cut.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from . import faults as ft_faults
from .faults import DeviceLoss, PoisonBatch

_log = logging.getLogger("repro_torch.ft")


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str | None = None        # None: no checkpoints, so no restore
    ckpt_every: int = 50
    keep_last: int = 3
    heartbeat_path: str = ""           # default: <ckpt_dir>/heartbeat.json
    straggler_window: int = 20
    straggler_zscore: float = 4.0
    max_failures: int = 3
    failure_decay_steps: int = 25      # consecutive successes that forgive
                                       # one recorded failure
    backoff_base_s: float = 0.05       # restore backoff: base * 2**(k-1),
    backoff_cap_s: float = 2.0         # capped, +- jitter
    backoff_jitter: float = 0.25       # fraction of the delay randomised
    jitter_seed: int = 0               # per-supervisor jitter stream
    max_poison_skips: int = 3          # consecutive poison batches before
                                       # the job is declared sick (re-raise)


class FailurePolicy:
    """The classify -> log -> count -> backoff -> decay core shared by the
    train loop's :class:`StepSupervisor` and a serving loop.

    One instance is one failure budget: ``count()`` charges a failure
    against ``cfg.max_failures`` and says whether the budget still holds;
    ``note_success()`` forgives one failure per ``failure_decay_steps``
    consecutive successes. Classes whose policy is in
    ``faults.SHED_POLICIES`` are logged but never counted: shedding load is
    the system working as designed. Backoff delays stay within
    ``backoff_cap_s * (1 + backoff_jitter)`` for any ``jitter_seed``."""

    def __init__(self, cfg: FTConfig):
        self.cfg = cfg
        self.failures = 0
        self.failure_log: list[dict] = []
        self._streak = 0
        self._rng = np.random.default_rng(cfg.jitter_seed)

    def record(self, cls: type, step: int, exc: BaseException) -> str:
        """Append one classified failure to the log; returns its policy name
        (``"shed"`` entries are the caller's cue to skip :meth:`count`)."""
        policy = ft_faults.POLICIES[cls]
        self.failure_log.append(
            {"step": step, "class": cls.__name__, "policy": policy,
             "error": f"{type(exc).__name__}: {exc}", "time": time.time()})
        return policy

    def count(self) -> bool:
        """Charge one failure against the budget; False = exhausted."""
        self.failures += 1
        self._streak = 0
        return self.failures <= self.cfg.max_failures

    def note_success(self) -> None:
        self._streak += 1
        if self.failures > 0 and self._streak >= self.cfg.failure_decay_steps:
            self.failures -= 1
            self._streak = 0

    def backoff(self) -> float:
        """Exponential backoff with jitter for the k-th restore since the last
        forgiven failure, so restarts after a shared blip do not stampede in
        lockstep."""
        k = max(self.failures, 1)
        base = min(self.cfg.backoff_base_s * (2.0 ** (k - 1)), self.cfg.backoff_cap_s)
        jit = 1.0 + self.cfg.backoff_jitter * (2.0 * self._rng.random() - 1.0)
        return max(base * jit, 0.0)


def _host_id() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class StepSupervisor:
    """``model``: the model whose train state the loop runs; one cut for
    training (``checkpoint.sharded.is_sharded``) checkpoints through
    ``ShardedCheckpointManager``."""

    def __init__(self, cfg: FTConfig, model=None):
        from ..checkpoint.sharded import ShardedCheckpointManager, is_sharded
        self.cfg = cfg
        self.ckpt = None
        if cfg.ckpt_dir and model is not None and is_sharded(model):
            self.ckpt = ShardedCheckpointManager(cfg.ckpt_dir, model, cfg.keep_last)
        elif cfg.ckpt_dir:
            self.ckpt = CheckpointManager(cfg.ckpt_dir, cfg.keep_last)
        self.hb_path = cfg.heartbeat_path or (
            os.path.join(cfg.ckpt_dir, "heartbeat.json") if cfg.ckpt_dir else "")
        self.times: deque[float] = deque(maxlen=cfg.straggler_window)
        self.straggler_events: list[dict] = []
        self.policy = FailurePolicy(cfg)
        self.skipped_batches: list[dict] = []

    @property
    def failures(self) -> int:
        return self.policy.failures

    @failures.setter
    def failures(self, v: int) -> None:
        self.policy.failures = v

    @property
    def failure_log(self) -> list[dict]:
        return self.policy.failure_log

    # ------------------------------------------------------------------
    def resume_or_init(self, init_fn: Callable[[], Any], like: Any | None = None):
        """Restore the newest valid checkpoint into ``like`` (else into
        ``init_fn()``), or start fresh. Returns ``(state, step, extra)``."""
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            like = like if like is not None else init_fn()
            step, state, extra = self.ckpt.restore(like)
            return state, step, extra
        return init_fn(), 0, {}

    # ------------------------------------------------------------------
    def heartbeat(self, step: int, metrics: dict | None = None) -> None:
        """Write the heartbeat file (in a joined world, rank 0 alone)."""
        if not self.hb_path or _host_id() != 0:
            return
        tmp = self.hb_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": int(step), "time": time.time(), "host": _host_id(),
                       "metrics": {k: float(v) for k, v in (metrics or {}).items()}}, f)
        os.replace(tmp, self.hb_path)

    def check_straggler(self, dt: float) -> bool:
        """True if this step is a straggler against the trailing window. The
        straggler's time still enters the window, so a sustained slowdown
        re-baselines instead of flagging every step."""
        flagged = False
        if len(self.times) >= self.cfg.straggler_window // 2:
            mu = float(np.mean(self.times))
            sd = float(np.std(self.times)) + 1e-9
            if (dt - mu) / sd > self.cfg.straggler_zscore and dt > 1.5 * mu:
                self.straggler_events.append(
                    {"dt": dt, "mean": mu, "std": sd, "time": time.time()})
                flagged = True
        self.times.append(dt)
        return flagged

    # ------------------------------------------------------------------
    def run(self, state, step_fn: Callable, data_iter, steps: int, start_step: int = 0,
            loader_state_fn=None, on_metrics: Callable | None = None,
            on_device_loss: Callable | None = None):
        """The supervised loop: step -> heartbeat -> (checkpoint) ->
        straggler check. Failures route through the ``ft.faults`` taxonomy:

        * unclassified exceptions re-raise at once: they are bugs, not faults;
        * ``PoisonBatch`` (a non-finite loss) skips the batch with a log entry
          and keeps the state: a restore would replay the same batch;
        * ``DeviceLoss`` calls ``on_device_loss(state) -> state`` and retries
          the step, else re-raises;
        * everything else (``TransientStep``, ``CorruptStream``) restores the
          newest verified checkpoint after an exponential backoff with
          jitter, up to ``max_failures``, and puts the loader back at the
          checkpoint's ``loader_step``.

        Returns ``(state, step)``."""
        step = start_step
        poison_run = 0
        while step < steps:
            batch = next(data_iter)
            t0 = time.time()
            try:
                new_state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise PoisonBatch(f"non-finite loss {loss} at step {step}")
                state = new_state
            except Exception as e:  # noqa: BLE001 - classified below
                cls = ft_faults.classify(e)
                if cls is None:
                    raise              # a bug, not a fault
                pol = self.policy.record(cls, step, e)
                if pol in ft_faults.SHED_POLICIES:
                    step += 1
                    continue
                if cls is PoisonBatch:
                    poison_run += 1
                    self.skipped_batches.append({"step": step, "error": str(e)})
                    _log.warning("poison batch at step %d skipped (%s): state kept, "
                                 "%d/%d consecutive", step, str(e), poison_run,
                                 self.cfg.max_poison_skips)
                    if poison_run > self.cfg.max_poison_skips:
                        raise          # every batch is poison: the data is sick
                    step += 1          # the batch is consumed; the step is a
                    continue           # logged no-op, not a retry loop
                if cls is DeviceLoss and on_device_loss is not None:
                    _log.warning("device loss at step %d: re-meshing (%s)", step, e)
                    state = on_device_loss(state)
                    self.policy._streak = 0
                    continue
                within_budget = self.policy.count()
                if self.ckpt is not None:
                    self.ckpt.wait()   # an in-flight save may be the newest point
                if not within_budget or self.ckpt is None or self.ckpt.latest_step() is None:
                    raise
                delay = self.policy.backoff()
                # the text, not the exception: a handler that keeps its records
                # would keep the traceback, and so the step's tensors
                _log.warning("%s at step %d (%s): restoring after %.2fs (failure %d/%d)",
                             cls.__name__, step, str(e), delay, self.failures,
                             self.cfg.max_failures)
                if delay:
                    time.sleep(delay)
                step, state, extra = self.ckpt.restore(state)
                if loader_state_fn:
                    data_iter.restore(extra.get("loader_step", step))
                continue
            dt = time.time() - t0
            step += 1
            poison_run = 0
            self.policy.note_success()
            self.check_straggler(dt)
            if step % 10 == 0 or step == steps:
                self.heartbeat(step, metrics)
            if on_metrics:
                on_metrics(step, {k: float(v) for k, v in metrics.items()})
            if self.ckpt is not None and (step % self.cfg.ckpt_every == 0 or step == steps):
                extra = {"loader_step": loader_state_fn() if loader_state_fn else step}
                self.ckpt.save(step, state, extra)
        if self.ckpt is not None:
            self.ckpt.wait()
        return state, step


# ---------------------------------------------------------------------------
# Elastic re-mesh
# ---------------------------------------------------------------------------

def remesh_model(model: int, n: int) -> int:
    """The model axis the reference's re-mesh keeps on ``n`` live devices:
    ``model`` halved while it does not divide ``n`` or exceeds it."""
    while model > 1 and (n % model or model > n):
        model //= 2
    return model


def remesh_state(state, cfg, old_mesh, spec_fn, *, model) -> tuple[Any, Any]:
    """Rebuild the mesh from the live world and re-cut ``state`` on it (the
    reference's ``remesh_state``). The live count is the joined world's
    size (the reference's ``len(jax.devices())``); the model axis is
    ``old_mesh``'s, cut by :func:`remesh_model`; the new mesh is
    ``make_host_mesh(model=...)``. ``spec_fn(state, cfg, mesh)`` gives
    the whole state's specs on a mesh (``distributed.sharding.
    train_state_specs``), read here from a whole-shaped copy of ``state``
    on the meta device; its parameters' specs become the model's
    placements, which the other leaves mirror.

    ``model``: the model cut for training on ``old_mesh`` whose train state
    ``state`` is (its parameters are the state's own tensors, so the
    port's re-mesh needs it). Each leaf is gathered whole over
    ``old_mesh``, one at a time, and the state and the module are re-cut
    by the checkpoint restore's re-cut (``checkpoint.sharded.recut_``);
    the module then records the new mesh and placements. Returns
    ``(new_state, new_mesh)``."""
    import torch.distributed as dist

    from ..checkpoint.manager import map_leaves
    from ..checkpoint.sharded import gather_leaf, leaf_places, recut_, whole_shape
    from ..distributed.sharding import mesh_shape, to_shardings
    from ..launch.mesh import make_host_mesh
    m = remesh_model(mesh_shape(old_mesh).get("model", 1), dist.get_world_size())
    new_mesh = make_host_mesh(model=m, device=next(model.parameters()).device)
    old_places = model.train_places

    def whole_meta(key, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        shape = whole_shape(leaf.shape, leaf_places(old_places, key, old_mesh), old_mesh)
        return torch.empty(shape, dtype=leaf.dtype, device="meta")

    def whole_of(key, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return gather_leaf(leaf, leaf_places(old_places, key, old_mesh), old_mesh, dst=None)
    specs = spec_fn(map_leaves(state, whole_meta), cfg, new_mesh)
    model.mesh, model.train_places = new_mesh, to_shardings(specs["params"], new_mesh)
    return recut_(state, model, whole_of), new_mesh
