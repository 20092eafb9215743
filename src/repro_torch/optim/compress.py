"""Gradient compression (``repro.optim.compress``): the wire format a
gradient takes before an all-reduce, decoded back to float32.

Three modes:
  * ``none``: the gradients as they are.
  * ``bf16``: a round trip through bfloat16 (half the wire bytes),
    stateless.
  * ``int8`` with error feedback: per-tensor max-abs scaling to int8 (a
    quarter of the bytes), the quantization residual carried to the next
    step so the compression bias vanishes over time.

The port runs on one card, so nothing crosses a link yet: the round trip
is applied where the reference applies it, before the (implicit)
all-reduce, and changes the update exactly as it does there. Gradients
are dicts of name -> float32 tensor; they are decoded in place (the train
step owns them), so a step at gemma3-4b's width holds no second copy.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

MODES = ("none", "bf16", "int8")


class CompressionState(NamedTuple):
    error: dict[str, torch.Tensor] | None     # residual carried between steps (int8)


def init_state(params: dict[str, torch.Tensor], mode: str = "bf16") -> CompressionState:
    if mode == "int8":
        return CompressionState(error={k: torch.zeros_like(p, dtype=torch.float32)
                                       for k, p in params.items()})
    return CompressionState(error=None)


@torch.no_grad()
def compressed_gradients(grads: dict[str, torch.Tensor], state: CompressionState,
                         mode: str = "bf16"):
    """Returns (wire-format grads decoded back to float32, new state). A
    float32 gradient is decoded in place; the int8 residual is updated in
    place in ``state.error``.

    int8: ``g + e`` rounded once, the scale ``max(max|g + e|, 1e-12) /
    127`` in float32, ``round`` half to even (as ``jnp.round``), clipped to
    ±127, decoded as ``q · scale``; the residual is ``(g + e) - q · scale``
    rounded once."""
    if mode == "none":
        return grads, state
    if mode == "bf16":
        out = {}
        for k, g in grads.items():
            h = g.to(torch.bfloat16)
            out[k] = g.copy_(h) if g.dtype == torch.float32 else h.to(torch.float32)
            del h
        return out, state
    if mode == "int8":
        out = {}
        for k, g in grads.items():
            e = state.error[k]
            e.add_(g.to(torch.float32))               # g + e: the carried residual added
            scale = torch.clamp(e.abs().amax(), min=1e-12) / 127.0
            q = torch.round(e / scale).clamp_(-127, 127).to(torch.int8)
            dec = q.to(torch.float32).mul_(scale)
            # the new residual (g + e) - q·scale, rounded once: the compiled
            # reference contracts it into a fused multiply-add. q·scale is
            # exact in float64 and so is the difference (|residual| <=
            # scale / 2), so one rounding to float32 remains
            e.copy_(e.double().sub_(q.double().mul_(scale.double())))
            del q
            out[k] = g.copy_(dec) if g.dtype == torch.float32 else dec
            del dec
        return out, state
    raise ValueError(f"unknown compression mode {mode!r}; known: {MODES}")
