"""Rematerialisation of the LM's layer units (the reference's
``LM._maybe_remat`` and ``checkpoint_name``), on ``torch.utils.checkpoint``.

``LMConfig.remat`` picks what the backward keeps of one unit, one repeat
of a run's layer pattern:

``none``       everything autograd saves;
``block``      the unit's inputs only: the backward runs the unit's forward
               again (the reference's ``nothing_saveable``);
``save_acts``  the unit's inputs and the maps named by
               :func:`checkpoint_name` (``attn_out``, ``ffn_hidden``), the
               rest recomputed (``save_only_these_names``). PyTorch has no
               named saves; selective checkpointing does it here, with a
               policy that saves the output of ``repro_torch::checkpoint_name``,
               an identity op that stands where the reference names a map.
               (Cutting the unit into checkpointed segments at those maps
               would also keep the residual at every cut, and give
               ``save_acts`` units of its own.)

Recomputation runs the same ops on the same inputs, so no value moves. It
runs in the context variables of the forward (:func:`in_context`):
on the card autograd runs the backward, and with it the recompute, on a
thread of its own, where the caller's context (``distributed.ctx``'s mesh
and tensor-parallel layout, the site recorders) is not set. It
does run the unit's Python again: a Zebra kernel inside it launches once in
the forward and once more in the backward, and its launch counter counts
both. Fault taps and stream validation run in infer mode only, where no
unit is checkpointed. Without gradients (``torch.no_grad``, inference
mode) a unit is a plain call.
"""
from __future__ import annotations

import contextvars
import functools

import torch
# ``checkpoint`` imports torch._dynamo at its first call, and that import
# leaves its frames in a reference cycle (``torch.fx.wrap`` keeps its own
# frame) that holds the caller's whole stack, the model and its state among
# it, until a full garbage collection: imported here, it holds no tensor
import torch._dynamo  # noqa: F401
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

REMATS = ("none", "block", "save_acts")


@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def _named(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_named.register_fake
def _(x, name):
    return torch.empty_like(x)


_named.register_autograd(lambda ctx, g: (g, None))


def checkpoint_name(x: torch.Tensor, name: str, remat: str) -> torch.Tensor:
    """Mark ``x`` as a map that ``save_acts`` keeps (a copy of it, under
    ``save_acts`` with gradients on); otherwise ``x`` itself."""
    if remat == "save_acts" and torch.is_grad_enabled():
        return _named(x, name)
    return x


def _save_named(ctx, op, *args, **kwargs):
    if op is torch.ops.repro_torch.checkpoint_name.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _run_in(ctx: contextvars.Context, fn, *args):
    return ctx.copy().run(fn, *args)


def in_context(fn):
    """``fn`` run, whenever it is called (a checkpoint's forward and its
    recompute), in a copy of the caller's context variables as they are
    now."""
    return functools.partial(_run_in, contextvars.copy_context(), fn)


def run_unit(fn, remat: str, *args):
    """``fn(*args)`` under the ``remat`` policy."""
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r}; known: {REMATS}")
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if remat == "block":
        return checkpoint(in_context(fn), *args, use_reentrant=False)
    return checkpoint(in_context(fn), *args, use_reentrant=False, context_fn=functools.partial(
        create_selective_checkpoint_contexts, _save_named))
